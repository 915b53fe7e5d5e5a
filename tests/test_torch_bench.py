"""The port's bench entry (`mcaq_yolo_tpu_torch/bench.py`, the counterpart
of the root `bench.py`) and its README generator
(`mcaq_yolo_tpu_torch/scripts/gen_readme_tables.py`) on the CPU.

  * the bench's two programs against the JAX bench's (`bench.py:141-159`)
    at 64 px, bs 2, float32, yolov8n, nc 80, MLP mapper, ds 2, on JAX's
    `model.init` weights carried across by `load_jax_variables` (the class
    outputs redrawn so that detections pass the serving gate): the raw
    forward's maps within 2e-4 on >= 99.9% of elements and avg_bits within
    1e-6 relative (the deployed slice's tolerances, ROADMAP C); the
    deployed program's detections (conf 0.25, IoU 0.45, max_det 300, pool
    256) equal JAX's `decode_and_nms` where the scores are separated by
    more than the raw maps' tolerance;
  * `BENCH_ALLOW_CPU=1 BENCH_QUICK=1` at 64 px, bs 2, in a copy of the
    package: rc 0, bench.py's keys and metric name, vs_baseline = value /
    151, 5 runs, the record written; without CUDA and without
    BENCH_ALLOW_CPU: rc 2 and one error line; with a card that cannot be
    used, rc 2 even with BENCH_ALLOW_CPU; the reference is looked for only
    inside the checkout;
  * the retry wrapper through BENCH_SELF, as tests/test_scripts.py holds
    the root bench.py's: no retry on success, one on the stall class, none
    on a genuine error;
  * the train arm at yolov8n, bs 2, 64 px, one step a run: images/s > 0;
  * `gen_readme_tables`: `--check` fails on a stale block and passes after
    regeneration, the JAX block untouched; the committed README's port
    block (and the JAX one) are up to date.

One torch thread is pinned for the module, and for the subprocesses.
"""

import json
import os
import shutil
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.models import MCAQYOLO as JaxMCAQYOLO
from mcaq_yolo_tpu.models.yolo import decode_and_nms as jax_decode_and_nms
from mcaq_yolo_tpu.scripts import gen_readme_tables as jax_tables
from mcaq_yolo_tpu_torch import bench
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables
from mcaq_yolo_tpu_torch.scripts import gen_readme_tables as tables

REPO = Path(__file__).resolve().parents[1]
IMG, BATCH, NC = 64, 2, 80
METRIC = "yolov8n_mcaq_e2e_infer_640_images_per_sec_per_chip"
# the class outputs' 1x1 convolutions redrawn: a random init's class features
# are ~1e-4, so its scores all sit at the bias; at this gain and bias ~16 of
# the 84 anchors of a 64 px image pass conf 0.25, with scores spread to 0.9
CLS_GAIN, CLS_BIAS = 1e3, -3.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(OMP_NUM_THREADS="1", **kw)
    return env


# ---------------------------------------------------------------------------
# the bench's programs against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def programs():
    """(the port's model, the images; JAX's raw maps, avg_bits and
    detections) on the same weights and images."""
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=NC, bit_mapping="mlp",
                     dtype=jnp.float32, morph_downsample=2)
    x = np.random.default_rng(1).random((BATCH, IMG, IMG, 3)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, a: jm.init(k, a, training=False))(jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    rng = np.random.default_rng(2)
    for i in range(3):
        head = v["params"]["head"][f"cls{i}_out"]
        head["kernel"] = (rng.normal(0, 1, head["kernel"].shape) * CLS_GAIN).astype(np.float32)
        head["bias"] = np.full_like(head["bias"], CLS_BIAS)
    raw, aux = jax.jit(partial(jm.apply, temperature=1.0, quantize=True, training=False))(
        v, jnp.asarray(x))
    det = jax_decode_and_nms(raw, NC, conf_threshold=0.25, iou_threshold=0.45, max_det=300,
                             pre_topk=256)
    model, nc = bench._model("yolov8n", torch.float32, torch.device("cpu"), morph_ds=2)
    assert nc == NC and not model.training
    load_jax_variables(model, v)
    ref = {"raw": [np.asarray(r) for r in raw], "avg_bits": float(aux["avg_bits"]),
           "det": [np.asarray(d) for d in det]}
    return model, torch.from_numpy(x), ref


def test_bench_forward_program_equals_jax(programs):
    model, images, ref = programs
    with torch.inference_mode():
        raw, avg_bits = bench._program(model, images, NC, e2e=False)()
    assert float(avg_bits) == pytest.approx(ref["avg_bits"], rel=1e-6)
    for o, r in zip(raw, ref["raw"]):
        o = o.numpy()
        assert o.shape == r.shape and np.isfinite(o).all()
        close = np.abs(o - r) <= 2e-4 + 2e-4 * np.abs(r)
        assert close.mean() >= 0.999, f"only {close.mean():.5f} of raw-map elements within 2e-4"


def test_bench_deployed_program_equals_jax(programs):
    model, images, ref = programs
    with torch.inference_mode():
        out = bench._program(model, images, NC, e2e=True)()
    boxes, scores, classes, valid, avg_bits = (o.numpy() for o in out[:5])
    rb, rs, rc, rv = ref["det"]
    assert float(avg_bits) == pytest.approx(ref["avg_bits"], rel=1e-6)
    assert boxes.shape == rb.shape == (BATCH, 300, 4)
    tol = 2e-4
    for b in range(BATCH):
        assert rv[b].sum() > 10  # the gate passes detections: the NMS has work
        s_ref = np.sort(rs[b][rv[b]])[::-1]
        # a score within tol of the gate or of another one may swap or drop
        separated = np.all(np.abs(s_ref[:, None] - s_ref[None, :]) + np.eye(len(s_ref)) > tol,
                           axis=1) & (np.abs(s_ref - 0.25) > tol)
        if separated.all():
            assert valid[b].sum() == rv[b].sum()
        for box, score, cls in zip(rb[b][rv[b]], rs[b][rv[b]], rc[b][rv[b]]):
            if not separated[np.searchsorted(-s_ref, -score)]:
                continue
            hit = valid[b] & (classes[b] == cls) & (np.abs(scores[b] - score) <= tol) & (
                np.abs(boxes[b] - box).max(axis=1) <= 0.05)
            assert hit.sum() == 1, (b, box, score, cls)


# ---------------------------------------------------------------------------
# the entry as a user runs it
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def package_copy(tmp_path_factory):
    """A copy of the package, so that the runs write their record there and
    the committed `evidence/torch/bench_last.json` stays as it is."""
    root = tmp_path_factory.mktemp("bench_copy")
    shutil.copytree(REPO / "mcaq_yolo_tpu_torch", root / "mcaq_yolo_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _run(root, env, timeout=240):
    return subprocess.run([sys.executable, "-m", "mcaq_yolo_tpu_torch.bench"], cwd=root,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_bench_runs_on_the_cpu_when_asked(package_copy):
    r = _run(package_copy, _env(BENCH_ALLOW_CPU="1", BENCH_QUICK="1", BENCH_IMG=str(IMG),
                                BENCH_HEADLINE_BATCH=str(BATCH), BENCH_ITERS="4"))
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    last = lines[-1]
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert last["metric"] == METRIC and last["unit"] == "images/sec"
    assert last["value"] > 0 and last["vs_baseline"] == round(last["value"] / 151.0, 3)
    ex = last["extra"]
    assert ex["headline_config"] == f"bs{BATCH}_ds2" and ex["skipped_arms"] == []
    assert ex["device"] == {"device": "cpu"}
    assert len(ex["e2e_decode_nms_sweep_imgs_per_sec_runs"][f"bs{BATCH}_ds2"]) == bench.RUNS
    # 2 warm-up calls and 5 runs of max(4, 4 // 4) calls; the CPU runs no kernel
    assert ex["launches"]["headline"] == {"spatial_quant": 0, "phi_tiles": 0, "calls": 22}
    record = package_copy / "evidence" / "torch" / "bench_last.json"
    assert json.loads(record.read_text()) == last
    assert not (record.parent / ".bench_last.json.tmp").exists()


def test_bench_refuses_the_cpu_unless_asked(package_copy):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench runs on it")
    r = _run(package_copy, _env(BENCH_IMG=str(IMG), BENCH_HEADLINE_BATCH=str(BATCH)))
    assert r.returncode == 2
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1  # not retried: no stall
    err = json.loads(lines[0])
    assert err["value"] == 0.0 and "BENCH_ALLOW_CPU" in err["error"]


def test_bench_refuses_an_unusable_card_even_when_cpu_is_allowed():
    """A card that is there but out of LOCAL_RANK's reach is an error, never
    a silent move to the CPU."""
    code = ("import torch; torch.cuda.is_available = lambda: True\n"
            "from mcaq_yolo_tpu_torch import bench\n"
            "print(bench._ensure_backend())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env=_env(BENCH_ALLOW_CPU="1", LOCAL_RANK="7"))
    assert r.returncode == 2, r.stdout + r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    err = json.loads(lines[0])
    assert err["value"] == 0.0 and "cannot be used" in err["error"]


def test_bench_looks_for_the_reference_inside_the_checkout():
    assert bench.REFERENCE.resolve().parent == REPO
    why = bench._reference_missing()
    if why is not None:
        assert "inside the repository" in why


def test_bench_retry_wrapper(tmp_path):
    """The wrapper streams the child's lines, retries ONCE on the stall class
    (the watchdog's 'did not complete' line) and passes genuine results and
    errors through without retrying."""

    def run_with_child(code):
        child = tmp_path / f"child_{abs(hash(code)) % 99999}.py"
        child.write_text(code)
        return _run(REPO, _env(BENCH_SELF=str(child), BENCH_RETRY_COOLDOWN_S="0",
                               BENCH_TIME_BUDGET_S="30"), timeout=120)

    ok = '{"metric": "images_per_sec", "value": 42.0}'
    r = run_with_child(f"print('{ok}')")
    assert r.returncode == 0 and r.stdout.count('"value": 42.0') == 1

    stall = ('{"metric": "images_per_sec", "value": 0.0, '
             '"error": "headline arm did not complete within budget"}')
    r = run_with_child(f"import sys; print('{stall}'); sys.exit(2)")
    assert r.returncode == 2 and r.stdout.count("did not complete") == 2

    err = '{"metric": "images_per_sec", "value": 0.0, "error": "some assertion failed"}'
    r = run_with_child(f"import sys; print('{err}'); sys.exit(2)")
    assert r.returncode == 2 and r.stdout.count("assertion failed") == 1


def test_bench_train_arm_steps():
    res = bench._train_imgs_per_sec("yolov8n", BATCH, IMG, 1, torch.device("cpu"))
    assert res["images_per_s"] > 0 and len(res["runs"]) == bench.RUNS
    assert res["calls"] == 1 + bench.RUNS
    assert res["launches_per_call"] == {"spatial_quant": 0, "phi_tiles": 0}


# ---------------------------------------------------------------------------
# gen_readme_tables
# ---------------------------------------------------------------------------


def _block(text, begin, end):
    return text[text.index(begin):text.index(end) + len(end)]


def test_gen_readme_tables_check_and_regenerate(tmp_path):
    readme = (REPO / "README.md").read_text()
    stale = readme.replace(_block(readme, tables.BEGIN, tables.END),
                           tables.BEGIN + "\n| stale |\n" + tables.END)
    (tmp_path / "README.md").write_text(stale)
    (tmp_path / "evidence" / "torch").mkdir(parents=True)
    record = {"metric": METRIC, "value": 4321.0, "unit": "images/sec",
              "vs_baseline": 28.616, "extra": {
                  "device": {"device": "NVIDIA H100 80GB HBM3",
                             "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"},
                  "headline_config": "bs256_ds2",
                  "e2e_decode_nms_sweep_imgs_per_sec": {"bs256_ds2": 4321.0},
                  "e2e_decode_nms_sweep_imgs_per_sec_runs": {"bs256_ds2": [4300.0, 4321.0]},
                  "fwd_only_imgs_per_sec": {"bs256_ds2": 5000.0},
                  "fwd_mfu_pct_bf16_peak": 4.4, "e2e_mfu_pct_bf16_peak": 3.8,
                  "train_yolov8m_bs32_imgs_per_sec_per_chip": 219.4,
                  "launches": {"headline": {"spatial_quant": 3.0, "phi_tiles": 3.0,
                                            "calls": 27}},
                  "skip_reasons": {"torch_cpu_fallback": "no reference"}}}
    (tmp_path / tables.BENCH).write_text(json.dumps(record))
    shutil.copy(REPO / tables.QUALITY, tmp_path / tables.QUALITY)

    with pytest.raises(SystemExit) as e:
        tables.main(["--check"], repo=tmp_path)
    assert e.value.code not in (0, None)
    tables.main([], repo=tmp_path)
    tables.main(["--check"], repo=tmp_path)  # returns: up to date
    new = (tmp_path / "README.md").read_text()
    assert _block(new, jax_tables.BEGIN, jax_tables.END) == \
        _block(readme, jax_tables.BEGIN, jax_tables.END)
    block = _block(new, tables.BEGIN, tables.END)
    assert "**4,321 images/s**" in block and "NVIDIA H100 80GB HBM3, 700.00 W" in block
    assert "989 TFLOP/s bf16 peak" in block and "v5e" not in block
    assert "spatial_quant 3, phi_tiles 3" in block and "no reference" in block
    assert "mAP@50-95" in block
    assert "219 images/s" in block and "clip at global norm 1.0" in block


def test_committed_readme_blocks_are_generated(capsys):
    tables.main(["--check"])
    jax_tables.main(["--check"])
    assert capsys.readouterr().out.count("up to date") == 2
