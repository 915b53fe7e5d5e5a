"""The port's inference command line and visualization on the CPU
(`python -m mcaq_yolo_tpu_torch.inference`, `Predictor.predict(...,
visualize=True)`, `utils/visualization.py`).

Contracts: on a directory of two PNGs with `--device cpu` the CLI's JSON
has, per image, the detection count and avg_bits of `Predictor.
predict_batch` run in this process (the same program on the same pixels:
equal exactly); on one image with `--visualize` it writes the complexity
and bit-allocation figures; every plotting function of the copy writes its
file, and each raises naming matplotlib when it is not installed."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mcaq_yolo_tpu_torch.data.dataset import read_image
from mcaq_yolo_tpu_torch.inference import Predictor
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
from mcaq_yolo_tpu_torch.utils import visualization as viz
from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parents[1]
IMG, NC = 64, 4


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    model = MCAQYOLO(num_classes=NC, morph_downsample=2, device="cpu", seed=1)
    meta = {"epoch": 0, "variant": "yolov8n", "num_classes": NC, "img_size": IMG,
            "config": {"quantization": {"bit_mapping": "mlp", "monotone_param": "softplus"},
                       "morphology": {"downsample": 2}}}
    ckpt = root / "m.ckpt"
    save_checkpoint(ckpt, to_jax_variables(model), meta)
    src = root / "images"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((48, 64), (70, 50))):
        cv2.imwrite(str(src / f"im{i}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return root, ckpt, src


def _cli(*args):
    r = subprocess.run([sys.executable, "-m", "mcaq_yolo_tpu_torch.inference", *args],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_cli_directory_matches_predict_batch(served):
    root, ckpt, src = served
    out = root / "out.json"
    stdout = _cli("--model", str(ckpt), "--source", str(src), "--output", str(out),
                  "--device", "cpu", "--img-size", str(IMG), "--num-classes", str(NC),
                  "--conf", "0.001")
    summary = json.loads(out.read_text())
    assert summary["num_images"] == 2 and '"num_images": 2' in stdout
    files = sorted(str(p) for p in src.glob("*.png"))
    pred = Predictor(str(ckpt), img_size=IMG, num_classes=NC, conf_threshold=0.001,
                     device="cpu", warmup=False)
    results = pred.predict_batch([read_image(f) for f in files])
    assert list(summary["results"]) == files
    for f, r in zip(files, results):
        assert summary["results"][f]["num_detections"] == len(r["detections"])
        assert summary["results"][f]["avg_bits"] == r["avg_bits"]
    assert sum(len(r["detections"]) for r in results) > 0


def test_cli_single_image_with_visualize(served):
    root, ckpt, src = served
    vis = root / "vis"
    stdout = _cli("--model", str(ckpt), "--source", str(src / "im0.png"), "--visualize",
                  "--output-dir", str(vis), "--device", "cpu", "--img-size", str(IMG))
    dump = json.loads(stdout[stdout.index("{"):])
    assert 2.0 <= dump["avg_bits"] <= 8.0 and isinstance(dump["detections"], list)
    for name in ("complexity.png", "bits.png"):
        assert (vis / name).stat().st_size > 1000, name


def test_visualization_functions_write_files(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
    history = [{"epoch": e, "loss_total": 1.0 / (e + 1), "map50": 0.1 * e, "avg_bits": 4.0,
                "temperature": 1.0} for e in range(3)]
    paths = [
        viz.visualize_complexity_map(image, rng.uniform(size=(4, 4)), str(tmp_path / "c.png")),
        viz.visualize_bit_allocation(image, rng.integers(2, 9, (4, 4)), str(tmp_path / "b.png")),
        viz.plot_training_curves(history, str(tmp_path / "t.png")),
        viz.visualize_complexity_vs_performance(rng.uniform(size=20), rng.uniform(size=20),
                                                str(tmp_path / "s.png")),
        viz.create_summary_report(history, {"map50": 0.2, "images": 3}, str(tmp_path / "r.png"),
                                  bit_map=rng.integers(2, 9, (4, 4))),
    ]
    for p in paths:
        assert Path(p).stat().st_size > 1000, p


def test_visualization_names_matplotlib_when_absent(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        viz.visualize_bit_allocation(np.zeros((4, 4, 3), np.uint8), np.full((2, 2), 4.0))
