"""What a run loads holds no JAX and no JAX package; the reference loads
nothing of the measured program."""

import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mcaq_yolo_tpu")

_PROBE = """
import importlib, sys
from pathlib import Path
import perfbench.run as run
run.cache_env()
for p in sorted(Path('perfbench').rglob('*.py')):
    if 'tests' in p.parts:
        continue
    if p.parent.name == 'metrics':
        run.metric_reader(p.stem)
    else:
        importlib.import_module('.'.join(p.with_suffix('').parts).replace('.__init__', ''))
import mcaq_yolo_tpu_torch.inference, mcaq_yolo_tpu_torch.train  # noqa: E401
top = {m.split('.')[0] for m in sys.modules}
print('TOP', sorted(top & set(%r)))
""" % (FORBIDDEN,)


def test_a_run_loads_no_jax():
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TOP []" in r.stdout, r.stdout


def test_forbidden_names_are_compared_whole():
    from perfbench import run

    before = dict(sys.modules)
    try:
        sys.modules["mcaq_yolo_tpu_torch_fake"] = object()
        assert "mcaq_yolo_tpu" not in run.forbidden_modules() or "mcaq_yolo_tpu" in before
        sys.modules["jax"] = object()
        assert "jax" in run.forbidden_modules()
    finally:
        for k in ("mcaq_yolo_tpu_torch_fake", "jax"):
            if k not in before:
                sys.modules.pop(k, None)


def test_reference_imports_nothing_of_the_program():
    pat = re.compile(r"^\s*(import|from)\s+(mcaq_yolo_tpu\w*|jax|flax)\b", re.M)
    files = list((HERE / "reference").rglob("*.py"))
    assert files
    assert not [str(f) for f in files if pat.search(f.read_text())]
    probe = ("import sys, perfbench.reference.network, perfbench.reference.mcaq, "
             "perfbench.reference.train; "
             "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('mcaq')))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout
