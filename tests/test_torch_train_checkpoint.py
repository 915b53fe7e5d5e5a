"""A checkpoint written by the port's `Trainer` (yolov8n, 96 px, batch 2,
nc 4; two epochs with KD, then calibration and freezing) served by the JAX
`Predictor` and by the port's, and its detector exported as a teacher that
the flax YOLOv8 restores.

Contracts: no checkpoint leaf is missing or misshapen for either
Predictor; bit maps exactly equal; avg_bits within 1e-6 relative;
detection counts within 1 and at most one JAX detection without a
same-class port detection within 0.5 px (the class of
`test_torch_slice.py`: raw maps agree to 2e-4, so a score on the
confidence gate can flip)."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mcaq_yolo_tpu.inference import Predictor as JaxPredictor
from mcaq_yolo_tpu.models import YOLOv8 as JaxYOLOv8
from mcaq_yolo_tpu_torch.calibrate import calibrate
from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
from mcaq_yolo_tpu_torch.inference import Predictor
from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
from mcaq_yolo_tpu_torch.train import Trainer, export_teacher_from_ckpt
from mcaq_yolo_tpu_torch.utils.checkpoint import write_msgpack

IMG, NC, B, MB = 96, 4, 2, 8


def _config(tmp_path, kd):
    return {"epochs": 2, "batch_size": B, "learning_rate": 1e-3,
            "output_dir": str(tmp_path / "out"),
            "model": {"name": "yolov8n", "num_classes": NC,
                      "teacher_path": str(tmp_path / "teacher.msgpack")},
            "data": {"img_size": IMG}, "morphology": {"downsample": 2},
            "curriculum": {"warmup_epochs": 0, "transition_epochs": 0},
            "scheduler": {"warmup_epochs": 1}, "distillation": {"enabled": kd}}


def test_trainer_checkpoint_served_by_jax_predictor(tmp_path):
    """Two epochs (Stage 1, then Stage 3) with KD, then calibration and
    freezing: the checkpoint and its meta serve through the reference's
    Predictor with the port's bit maps and detections."""
    teacher = YOLOv8("yolov8n", NC, device="cpu", seed=1)
    (tmp_path / "teacher.msgpack").write_bytes(write_msgpack(to_jax_variables(teacher)))
    batches = synthetic_batches(1, B, IMG, NC, max_boxes=MB, boxes_per_image=(3, 6), seed=1)
    trainer = Trainer(_config(tmp_path, kd=True), batches, batches, device="cpu")
    epochs = [trainer.train_epoch(e) for e in range(2)]
    assert [e["stage"] for e in epochs] == [1, 3]
    assert all(np.isfinite(e["loss_total"]) for e in epochs)
    assert np.isfinite(trainer.compute_val_loss(1))
    boxes, _, _, valid, avg_bits = trainer.eval_step(torch.from_numpy(batches[0]["image"]), 1.0)
    assert boxes.shape == (B, 300, 4) and valid.shape == (B, 300)
    assert 2.0 <= float(avg_bits) <= 8.0
    calibrate(trainer.model, batches * 2, num_images=2 * B)
    path = trainer.save_checkpoint("last.ckpt", 1)
    meta = json.loads((tmp_path / "out" / "last.ckpt.json").read_text())
    assert meta["config"]["quantization"]["monotone_param"] == "softplus"
    assert meta["config"]["morphology"]["downsample"] == 2

    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((80, 120), (96, 96), (150, 60))]
    kw = dict(conf_threshold=0.001, max_det=300, warmup=False)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=r"\[MCAQ\] (checkpoint missing|shape)")
        ref = JaxPredictor(str(path), **kw).predict_batch(images, batch_size=2)
        out = Predictor(str(path), device="cpu", **kw).predict_batch(images, batch_size=2)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o["bit_map"], r["bit_map"])
        assert o["avg_bits"] == pytest.approx(r["avg_bits"], rel=1e-6)
        assert abs(len(o["detections"]) - len(r["detections"])) <= 1
        assert len(r["detections"]) > 0
        unmatched = sum(not any(e["class_id"] == d["class_id"] and
                                np.abs(np.subtract(e["bbox"], d["bbox"])).max() <= 0.5
                                for e in o["detections"]) for d in r["detections"])
        assert unmatched <= 1

    # the detector exported as a teacher restores into the flax YOLOv8
    tpath = export_teacher_from_ckpt(str(path), str(tmp_path / "t.msgpack"), "yolov8n", NC)
    template = JaxYOLOv8("yolov8n", NC).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 32, 32, 3)))
    restored = serialization.from_bytes(template, open(tpath, "rb").read())
    np.testing.assert_array_equal(
        restored["params"]["head"]["cls0_out"]["bias"],
        to_jax_variables(trainer.model)["params"]["head"]["cls0_out"]["bias"])


def test_trainer_fails_fast_without_teacher(tmp_path):
    with pytest.raises(FileNotFoundError, match="teacher_path"):
        Trainer(_config(tmp_path, kd=True), [None], device="cpu")
