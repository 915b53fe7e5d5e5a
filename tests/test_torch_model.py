"""The port's YOLOv8, morphology, bit mappers and decode + NMS against the
JAX reference on the CPU, on the same weights (carried across with
`load_jax_variables`) and the same numpy-seeded inputs.

Tolerances:
  * raw maps 2e-4 abs/rel — the class `tests/test_weights_io.py` uses for
    torch-vs-JAX convolutions (summation order inside the convs);
  * phi maps and complexity 1e-5 — float rounding of sums and
    transcendentals; inputs are continuous random maps, away from the
    exactly-symmetric-gradient ties where Canny NMS can flip a pixel
    (`morphology_lanes.py:27-31`);
  * rounded bit maps exactly equal;
  * detections: identical valid sets, boxes within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.core import bit_allocation as jba
from mcaq_yolo_tpu.core import morphology as jmorph
from mcaq_yolo_tpu.models.yolo import YOLOv8 as JaxYOLOv8
from mcaq_yolo_tpu.models.yolo import decode_and_nms as jax_decode_and_nms
from mcaq_yolo_tpu_torch.core import bit_allocation as tba
from mcaq_yolo_tpu_torch.core import morphology as tmorph
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8, decode_and_nms
from mcaq_yolo_tpu_torch.ops.nms import stable_topk


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_bn(variables, seed):
    """Non-trivial BatchNorm statistics and affine parameters."""
    rng = np.random.default_rng(seed)

    def visit(tree, kind):
        for k, v in tree.items():
            if isinstance(v, dict):
                visit(v, kind)
            elif kind == "stats" and k == "mean":
                tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif kind == "stats" and k == "var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    visit(variables["batch_stats"], "stats")

    def params(tree, in_bn=False):
        for k, v in tree.items():
            if isinstance(v, dict):
                params(v, in_bn or k.startswith("BatchNorm"))
            elif in_bn and k == "scale":
                tree[k] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
            elif in_bn and k == "bias":
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)

    params(variables["params"])
    return variables


def test_yolov8_raw_maps_match_jax():
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = JaxYOLOv8(variant="yolov8n", num_classes=4)
    v = _perturb_bn(_np_tree(jax.jit(lambda k, a: jm.init(k, a))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))), seed=1)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = load_jax_variables(YOLOv8(num_classes=4, device="cpu"), v)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert len(out) == 3
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("H,downsample", [(32, 1), (64, 1), (64, 2)])
def test_phi_maps_match_jax(H, downsample):
    """H=64 with downsample=2 runs the half-resolution estimator (tile 8 -> 4);
    H=32 has tile 4, where a 2x request degrades to 1."""
    f = np.random.default_rng(H + downsample).normal(0, 1, (2, H, H, 6)).astype(np.float32)
    ref_phi, ref_det = jax.jit(
        lambda a: jmorph.compute_phi_tiles(a, downsample=downsample))(jnp.asarray(f))
    phi, det = tmorph.compute_phi_tiles(torch.from_numpy(f), downsample=downsample)
    assert phi.shape == ref_phi.shape
    np.testing.assert_allclose(phi.numpy(), np.asarray(ref_phi), atol=1e-5, rtol=0)
    for k in ref_det:
        np.testing.assert_allclose(det[k].numpy(), np.asarray(ref_det[k]), atol=1e-5)


def test_complexity_matches_jax():
    f = np.random.default_rng(3).normal(0, 1, (2, 64, 64, 8)).astype(np.float32)
    ja = jmorph.MorphologicalComplexityAnalyzer(downsample=2)
    v = _np_tree(ja.init(jax.random.PRNGKey(3), jnp.asarray(f)))
    ref = jax.jit(ja.apply)(v, jnp.asarray(f))
    port = load_jax_variables(tmorph.MorphologicalComplexityAnalyzer(downsample=2), v)
    with torch.no_grad():
        out = port(torch.from_numpy(f))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _calibrate_bn(jm, v, c, steps=60):
    """Running BatchNorm statistics of the data (the reference's training
    update, momentum 0.9), so the mapper's bits spread over the range."""
    step = jax.jit(lambda v: jm.apply(v, jnp.asarray(c), training=True,
                                      mutable=["batch_stats"])[1]["batch_stats"])
    for _ in range(steps):
        v = dict(v, batch_stats=step(v))
    return _np_tree(v)


@pytest.mark.parametrize("mode", ["softplus", "abs", "linear"])
def test_bit_maps_match_jax(mode):
    c = np.random.default_rng(4).uniform(0, 1, (3, 10, 10)).astype(np.float32)
    if mode == "linear":
        jm, port = jba.LinearBitMapper(), tba.LinearBitMapper()
        v = {}
    else:
        jm = jba.ComplexityToBitMappingNetwork(monotone_param=mode)
        v = _calibrate_bn(jm, _np_tree(jm.init(jax.random.PRNGKey(4), jnp.asarray(c))), c)
        port = load_jax_variables(tba.ComplexityToBitMappingNetwork(monotone_param=mode), v)
        port.eval()
    for temperature in (1.0, 0.7):
        ref = jm.apply(v, jnp.asarray(c), temperature)
        ref_c = jm.apply(v, jnp.asarray(c), temperature, return_continuous=True)
        with torch.no_grad():
            out = port(torch.from_numpy(c), temperature)
            out_c = port(torch.from_numpy(c), temperature, return_continuous=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_allclose(out_c.numpy(), np.asarray(ref_c), atol=1e-5, rtol=0)
    assert len(np.unique(np.asarray(ref))) > 1  # the comparison is not vacuous


def _raw_maps(size, nc, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 2, (2, size // s, size // s, 64 + nc)).astype(np.float32)
            for s in (8, 16, 32)]


@pytest.mark.parametrize("size,conf", [(64, 0.001), (128, 0.001), (128, 0.25)])
def test_decode_and_nms_matches_jax(size, conf):
    """size 64: pool of 84 (the reference's full-matrix core); size 128:
    pool of 256 (its block-sequential core)."""
    maps = _raw_maps(size, 4, seed=size)
    kw = dict(conf_threshold=conf, iou_threshold=0.45, max_det=300, pre_topk=256,
              with_pool_stats=True)
    ref = [np.asarray(a) for a in jax_decode_and_nms([jnp.asarray(m) for m in maps], 4, **kw)]
    out = [a.numpy() for a in decode_and_nms([torch.from_numpy(m) for m in maps], 4, **kw)]
    boxes, scores, classes, valid, gated = out
    np.testing.assert_array_equal(gated, ref[4])
    np.testing.assert_array_equal(valid, ref[3])
    assert valid.sum() > 0
    for b in range(2):
        v = valid[b]
        np.testing.assert_array_equal(classes[b][v], ref[2][b][v])
        np.testing.assert_allclose(scores[b][v], ref[1][b][v], atol=1e-6)
        np.testing.assert_allclose(boxes[b][v], ref[0][b][v], atol=1e-4)


def test_stable_topk_ties_match_lax_top_k():
    """Heavy ties: the port's order equals lax.top_k's (lowest index first)."""
    x = np.random.default_rng(6).integers(0, 5, (3, 200)).astype(np.float32)
    vals, idx = stable_topk(torch.from_numpy(x), 50)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 50)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
