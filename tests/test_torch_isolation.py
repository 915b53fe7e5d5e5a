"""The port stands alone: every module of `mcaq_yolo_tpu_torch` imports with
jax, flax and the JAX package blocked, none of them gets loaded, and the
entry points refuse to run without CUDA unless asked for the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "mcaq_yolo_tpu")
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    for name in BLOCKED:
        sys.modules[name] = None  # any import of it now raises ImportError

    import mcaq_yolo_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(mcaq_yolo_tpu_torch.__path__,
                                                   "mcaq_yolo_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    loaded = [n for n, m in sys.modules.items()
              if n.split(".")[0] in BLOCKED and m is not None]
    assert not loaded, loaded
    for name in ("train", "calibrate", "models.losses", "core.curriculum",
                 "batch_norm", "data.synthetic"):  # the training slice
        assert "mcaq_yolo_tpu_torch." + name in names, name

    import torch
    if not torch.cuda.is_available():
        from mcaq_yolo_tpu_torch.inference import Predictor
        from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
        from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
        from mcaq_yolo_tpu_torch.train import Trainer
        for build in (lambda: MCAQYOLO(num_classes=4), lambda: YOLOv8(num_classes=4),
                      lambda: Predictor("no-such.ckpt", warmup=False),
                      lambda: Trainer({"output_dir": "/nonexistent/never-made"}, [])):
            try:
                build()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("an entry point ran without CUDA or device='cpu'")
    print("ISOLATED", len(names))
""")


def test_port_imports_without_jax_and_needs_an_explicit_cpu():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split("ISOLATED")[1])
    assert n >= 21  # every submodule was imported


def test_port_sources_name_no_jax_import():
    """No import statement of the port or chip_smoke.py names jax, flax or
    the JAX package (a static check beside the runtime one above)."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|mcaq_yolo_tpu)\b", re.M)
    files = list((REPO / "mcaq_yolo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
