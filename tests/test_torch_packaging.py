"""An installed port can build its native libraries, and the port takes the
JAX package's options.

  * a wheel of the checkout ships `csrc/spatial_quant.cu`,
    `csrc/dataio.cpp` and the Triton kernel `csrc/conv_f32.py`, and the
    unpacked package's `ops/build.py` finds the first two
    sources and builds into the per-user cache, not into site-packages;
  * `Predictor(data_parallel=..., morph_tile_engine=...)`,
    `MCAQYOLO(morph_tile_engine=...)`, a checkpoint meta's
    `morphology.tile_engine`, and `training.parallel` 'dp' / 'fsdp' are
    accepted as the reference accepts them; anything else raises.
"""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from mcaq_yolo_tpu_torch.inference import Predictor
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
from mcaq_yolo_tpu_torch.ops import build
from mcaq_yolo_tpu_torch.train import Trainer
from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the gate's six workers on eight cores,
    each with eight OpenMP threads, slow these many small CPU ops ~80x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_wheel_ships_the_sources_and_builds_into_the_user_cache(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("setup.py", "setup.cfg", "bench.py"):
        shutil.copy(REPO / name, src / name)
    shutil.copytree(REPO / "mcaq_yolo_tpu_torch", src / "mcaq_yolo_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
                        "--no-build-isolation", "--no-index", "-q", "-w", str(tmp_path / "wh")],
                       cwd=src, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    (wheel,) = (tmp_path / "wh").glob("*.whl")
    site = tmp_path / "site"
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
        z.extractall(site)
    for f in ("spatial_quant.cu", "dataio.cpp", "conv_f32.py"):
        assert f"mcaq_yolo_tpu_torch/csrc/{f}" in names

    probe = ("from mcaq_yolo_tpu_torch.ops import build\n"
             "for n in ('spatial_quant', 'dataio'):\n"
             "    print(build._source_and_flags(n)[0], build.library_path(n))\n")
    env = dict(os.environ, PYTHONPATH=str(site), XDG_CACHE_HOME=str(tmp_path / "cache"))
    r = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for line in r.stdout.split("\n")[:2]:
        source, lib = line.split()
        assert Path(source).is_file() and Path(source).is_relative_to(site)
        assert Path(lib).parent == tmp_path / "cache" / "mcaq_yolo_tpu_torch" / "kernels"


def test_build_dir_is_the_checkout_only_when_it_can_write_there(tmp_path, monkeypatch):
    assert build.BUILD_DIR == REPO / "build" / "kernels"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    cache = tmp_path / "cache" / "mcaq_yolo_tpu_torch" / "kernels"
    assert build.build_dir(tmp_path) == cache  # no setup.py: not a checkout
    (tmp_path / "setup.py").write_text("")
    assert build.build_dir(tmp_path) == tmp_path / "build" / "kernels"
    monkeypatch.setattr(os, "access", lambda path, mode: False)
    assert build.build_dir(tmp_path) == cache  # read-only checkout
    monkeypatch.delenv("XDG_CACHE_HOME")
    assert build.build_dir(tmp_path) == (Path.home() / ".cache" / "mcaq_yolo_tpu_torch"
                                         / "kernels")


def test_predictor_and_model_take_the_reference_options(tmp_path):
    with pytest.raises(ValueError, match="morph_tile_engine"):
        MCAQYOLO(num_classes=4, morph_tile_engine="columns", device="cpu")
    model = MCAQYOLO(num_classes=4, morph_tile_engine="rows", device="cpu")
    assert model.morph_tile_engine == "rows"
    ckpt = tmp_path / "m.ckpt"
    save_checkpoint(ckpt, to_jax_variables(model),
                    {"variant": "yolov8n", "num_classes": 4, "img_size": 64,
                     "config": {"morphology": {"tile_engine": "rows"}}})
    pred = Predictor(str(ckpt), warmup=False, device="cpu")
    assert pred.model.morph_tile_engine == "rows"  # from the meta
    pred = Predictor(str(ckpt), warmup=False, device="cpu", data_parallel=True,
                     morph_tile_engine="lanes")
    assert pred.model.morph_tile_engine == "lanes"  # the explicit option wins
    image = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    assert pred.predict(image)["bit_map"].ndim == 2  # it serves


def test_training_parallel_takes_dp_and_fsdp_only(tmp_path):
    batch = {"image": np.zeros((2, 64, 64, 3), np.uint8),
             "gt_boxes": np.zeros((2, 4, 4), np.float32),
             "gt_classes": np.zeros((2, 4), np.int32), "gt_mask": np.zeros((2, 4), bool)}
    cfg = {"model": {"num_classes": 4}, "data": {"img_size": 64}, "batch_size": 2,
           "distillation": {"enabled": False}, "output_dir": str(tmp_path)}
    for mode in ("dp", "FSDP"):
        t = Trainer(dict(cfg, training={"parallel": mode}), [batch], [batch], device="cpu")
        assert t.parallel_mode == mode.lower()
    with pytest.raises(ValueError, match="training.parallel must be 'dp' or 'fsdp'"):
        Trainer(dict(cfg, training={"parallel": "ddp"}), [batch], [batch], device="cpu")
