"""The port's deployed inference slice as a whole against the JAX reference
on the CPU: MCAQ-YOLOv8n (nc=4, 96 px, batch 2, float32, morph
downsample 2) on the same weights and images.

Contracts:
  * bit maps exactly equal at all three scales; avg_bits equal to float32
    rounding (1e-6 relative: XLA folds the means' divisions into
    reciprocal multiplies, torch divides);
  * raw maps within 2e-4 on >= 99.9% of elements — the remainder is a
    feature that conv rounding moved across a quantization step, which
    then moves by one step;
  * at conf 0.001: valid-detection count within +-1, matched boxes within
    0.5 px, same classes;
  * a checkpoint written by flax (msgpack + the Trainer's `.json` meta)
    serves through the port's `Predictor(model_path, device="cpu")` with
    the JAX `Predictor`'s detections.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mcaq_yolo_tpu.core.bit_allocation import ComplexityToBitMappingNetwork as JaxMapper
from mcaq_yolo_tpu.inference import Predictor as JaxPredictor
from mcaq_yolo_tpu.models import MCAQYOLO as JaxMCAQYOLO
from mcaq_yolo_tpu.models.yolo import decode_and_nms as jax_decode_and_nms
from mcaq_yolo_tpu_torch.inference import Predictor
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import decode_and_nms

IMG, NC = 96, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def slice_pair():
    """(JAX model, variables, images, JAX outputs, port model)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=NC, morph_downsample=2)
    v = _np_tree(jax.jit(lambda k, x: jm.init(k, x, training=False))(
        jax.random.PRNGKey(0), jnp.asarray(images[:1])))
    apply = jax.jit(lambda v, x: jm.apply(v, x, temperature=1.0, quantize=True,
                                          training=False))
    # calibrate the mapper's BatchNorm on this model's complexity maps ...
    _, aux = apply(v, jnp.asarray(images))
    c = jnp.concatenate([m.reshape(-1) for m in aux["complexity_map"]]).reshape(1, 1, -1)
    mapper = JaxMapper()
    mv = {"params": v["params"]["bit_mapper"], "batch_stats": v["batch_stats"]["bit_mapper"]}
    step = jax.jit(lambda mv: mapper.apply(mv, c, training=True,
                                           mutable=["batch_stats"])[1]["batch_stats"])
    for _ in range(60):
        mv = dict(mv, batch_stats=step(mv))
    v["batch_stats"]["bit_mapper"] = _np_tree(mv["batch_stats"])
    # and steepen its output layer (softplus(theta) x 50): a random-init
    # monotone MLP is nearly flat over this narrow complexity range
    theta = v["params"]["bit_mapper"]["MonotoneDense_3"]["theta"]
    w = np.log1p(np.exp(theta.astype(np.float64))) * 50.0
    v["params"]["bit_mapper"]["MonotoneDense_3"]["theta"] = np.log(np.expm1(w)).astype(np.float32)

    raw, aux = apply(v, jnp.asarray(images))
    port = load_jax_variables(MCAQYOLO(num_classes=NC, morph_downsample=2, device="cpu"), v)
    return jm, v, images, (raw, aux), port


def test_slice_bit_maps_and_raw_maps(slice_pair):
    _, _, images, (ref_raw, ref_aux), port = slice_pair
    raw, aux = port(torch.from_numpy(images))
    for b, rb in zip(aux["bit_map"], ref_aux["bit_map"]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    assert float(aux["avg_bits"]) == pytest.approx(float(ref_aux["avg_bits"]), rel=1e-6)
    assert len(np.unique(np.concatenate([np.asarray(b).ravel() for b in ref_aux["bit_map"]]))) > 1
    # complexity maps are not compared here: at 96 px the P5 map (3x3) has
    # 2x2 tiles whose replicated borders put Canny on exact gradient ties,
    # so conv-rounding-level input differences can flip a pixel (the phi
    # contract is tested away from ties in test_torch_model.py)
    for o, r in zip(raw, ref_raw):
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == r.shape and np.isfinite(o).all()
        close = np.abs(o - r) <= 2e-4 + 2e-4 * np.abs(r)
        assert close.mean() >= 0.999, f"only {close.mean():.5f} of raw-map elements within 2e-4"


def _match(dets, ref_dets, tol=0.5):
    """Count reference detections with no same-class port detection within
    `tol` px on every coordinate."""
    unmatched = 0
    for box, cls in ref_dets:
        if not any(c == cls and np.abs(b - box).max() <= tol for b, c in dets):
            unmatched += 1
    return unmatched


def test_slice_detections(slice_pair):
    _, _, images, (ref_raw, _), port = slice_pair
    raw, _ = port(torch.from_numpy(images))
    kw = dict(conf_threshold=0.001, iou_threshold=0.45, max_det=300, pre_topk=512)
    ref = [np.asarray(a) for a in jax_decode_and_nms(ref_raw, NC, **kw)]
    out = [a.numpy() for a in decode_and_nms(raw, NC, **kw)]
    for b in range(images.shape[0]):
        v, rv = out[3][b], ref[3][b]
        assert rv.sum() > 0
        assert abs(int(v.sum()) - int(rv.sum())) <= 1
        dets = list(zip(out[0][b][v], out[2][b][v]))
        ref_dets = list(zip(ref[0][b][rv], ref[2][b][rv]))
        assert _match(dets, ref_dets) <= 1


def test_predictor_serves_a_flax_checkpoint(slice_pair, tmp_path):
    jm, v, _, _, _ = slice_pair
    path = tmp_path / "best.ckpt"
    path.write_bytes(serialization.msgpack_serialize(v))
    meta = {
        "epoch": 1, "variant": "yolov8n", "num_classes": NC, "img_size": IMG,
        "deploy_temperature": 1.0,
        "config": {
            "quantization": {"min_bits": 2, "max_bits": 8, "target_bits": 4.0,
                             "grid_size": 8, "bit_mapping": "mlp",
                             "monotone_param": "softplus", "normalize_complexity": False},
            "morphology": {"downsample": 2, "tile_engine": "lanes"},
        },
    }
    (tmp_path / "best.ckpt.json").write_text(json.dumps(meta))
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((80, 120), (96, 96), (150, 60))]
    kw = dict(conf_threshold=0.001, max_det=300, warmup=False)

    ref = JaxPredictor(str(path), **kw).predict_batch(images, batch_size=2)
    port = Predictor(str(path), device="cpu", **kw)
    out = port.predict_batch(images, batch_size=2)
    assert port.model.morph_downsample == 2 and port.pre_topk == 512
    for r, o in zip(ref, out):
        assert o["avg_bits"] == pytest.approx(r["avg_bits"], rel=1e-6)
        np.testing.assert_array_equal(o["bit_map"], r["bit_map"])
        assert abs(len(o["detections"]) - len(r["detections"])) <= 1
        dets = [(np.asarray(d["bbox"]), d["class_id"]) for d in o["detections"]]
        ref_dets = [(np.asarray(d["bbox"]), d["class_id"]) for d in r["detections"]]
        assert len(ref_dets) > 0 and _match(dets, ref_dets) <= 1
