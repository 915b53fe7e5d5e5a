"""The port's losses (`mcaq_yolo_tpu_torch/models/losses.py`) against the
JAX reference (`mcaq_yolo_tpu/models/losses.py`) on the CPU, on the same
numpy-seeded inputs: yolov8n raw-map shapes at 96 px (12x12, 6x6, 3x3
anchors), batch 2, nc 4, 8 box slots.

Tolerances:
  * the assigner's fg_mask and assigned boxes exactly equal; its target
    scores within 1e-5 relative (float rounding of pow / divide);
  * loss values within 1e-5 relative;
  * gradients w.r.t. the raw maps, boxes and bit maps: max |port - JAX| <=
    1e-5 x max |JAX| over each array (float rounding; summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.core.bit_allocation import ComplexityToBitMappingNetwork as JaxMapper
from mcaq_yolo_tpu.models import losses as jl
from mcaq_yolo_tpu.models.yolo import make_anchors as jax_make_anchors
from mcaq_yolo_tpu_torch.core.bit_allocation import ComplexityToBitMappingNetwork
from mcaq_yolo_tpu_torch.models import losses as tl
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables

B, NC, M, IMG = 2, 4, 8, 96
SHAPES = [(12, 12), (6, 6), (3, 3)]
REL = 1e-5


def _close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"max |diff| {err:.3g} > {rel} x {scale:.3g}"


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _targets(seed):
    """gt boxes (B, M, 4) in pixels, classes, mask with 5 and 3 valid rows."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(10, 50, (B, M, 2))
    x1y1 = rng.uniform(0, 1, (B, M, 2)) * (IMG - wh)
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    classes = rng.integers(0, NC, (B, M)).astype(np.int32)
    mask = np.zeros((B, M), bool)
    mask[0, :5] = True
    mask[1, :3] = True
    return boxes, classes, mask


def _raw_maps(seed):
    """Random raw maps whose DFL logits lean to the low bins, so decoded
    boxes are a few cells wide and overlap the ground truths."""
    rng = np.random.default_rng(seed)
    lean = np.concatenate([np.tile(-0.4 * np.arange(16), 4), np.zeros(NC)])
    return [(rng.normal(0, 1, (B, h, w, 64 + NC)) + lean).astype(np.float32)
            for h, w in SHAPES]


def test_ciou_value_and_gradients():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (2, 64, 2))
    wh = rng.uniform(1, 40, (2, 64, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    ref, (ga, gb) = jax.value_and_grad(
        lambda a, b: (jl.ciou(a, b) * w).sum(), argnums=(0, 1))(boxes[0], boxes[1])
    a, b = _t(boxes[0], True), _t(boxes[1], True)
    out = tl.ciou(a, b)
    (out * _t(w)).sum().backward()
    _close(out.detach().numpy(), jl.ciou(boxes[0], boxes[1]))
    _close(a.grad.numpy(), ga)
    _close(b.grad.numpy(), gb)
    _close(tl.box_iou_pairwise(a, b).detach().numpy(), jl.box_iou_pairwise(boxes[0], boxes[1]))


@pytest.mark.parametrize("seed", [1, 2])
def test_task_aligned_assign(seed):
    """Predicted boxes jittered around anchors and ground truths, so many
    anchors compete for several ground truths (conflicts included)."""
    rng = np.random.default_rng(seed)
    points, strides = (np.asarray(a) for a in jax_make_anchors(SHAPES))
    pts = points * strides
    A = pts.shape[0]
    gt_boxes, gt_classes, gt_mask = _targets(seed)
    half = rng.uniform(4, 30, (B, A, 2))
    pred_boxes = np.concatenate([pts - half, pts + half], -1).astype(np.float32)
    scores = rng.uniform(0.01, 0.99, (B, A, NC)).astype(np.float32)
    ref = [np.asarray(r) for r in jl.task_aligned_assign(
        scores, pred_boxes, pts, gt_boxes, gt_classes, gt_mask)]
    out = [r.numpy() for r in tl.task_aligned_assign(
        _t(scores), _t(pred_boxes), _t(pts), _t(gt_boxes), _t(gt_classes), _t(gt_mask))]
    np.testing.assert_array_equal(out[2], ref[2])  # fg_mask
    assert ref[2].sum() >= 10 and not ref[2].all()
    np.testing.assert_array_equal(out[0][ref[2]], ref[0][ref[2]])  # assigned boxes
    _close(out[1], ref[1])  # target scores


def test_bce_and_dfl_values_and_gradients():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (B, 50, NC)).astype(np.float32)
    targets = rng.uniform(0, 1, (B, 50, NC)).astype(np.float32)
    ref, g = jax.value_and_grad(lambda x: jl._bce_with_logits(x, targets).sum())(logits)
    x = _t(logits, True)
    out = tl.bce_with_logits(x, _t(targets)).sum()
    out.backward()
    _close(out.item(), ref)
    _close(x.grad.numpy(), g)

    dist = rng.normal(0, 2, (B, 50, 4, 16)).astype(np.float32)
    target = rng.uniform(0, 14.99, (B, 50, 4)).astype(np.float32)
    ref, g = jax.value_and_grad(lambda d: jl._dfl_loss(d, target).sum())(dist)
    d = _t(dist, True)
    out = tl.dfl_loss(d, _t(target)).sum()
    out.backward()
    _close(out.item(), ref)
    _close(d.grad.numpy(), g)


def test_detection_loss_values_and_gradients():
    maps = _raw_maps(4)
    gt_boxes, gt_classes, gt_mask = _targets(4)
    jloss = jl.DetectionLoss(NC)

    def jfn(m):
        vec, items = jloss(m, gt_boxes, gt_classes, gt_mask)
        return vec.sum(), (vec, items)

    (_, (ref_vec, ref_items)), grads = jax.value_and_grad(jfn, has_aux=True)(maps)
    tm = [_t(m, True) for m in maps]
    vec, items = tl.DetectionLoss(NC)(tm, _t(gt_boxes), _t(gt_classes), _t(gt_mask))
    vec.sum().backward()
    _close(vec.detach().numpy(), ref_vec)
    assert int(items["num_fg"]) == int(ref_items["num_fg"]) > 0
    for a, g in zip(tm, grads):
        _close(a.grad.numpy(), g)


def test_kd_and_map_terms_values_and_gradients():
    rng = np.random.default_rng(5)
    s = _raw_maps(5)
    t = _raw_maps(6)
    feats = [rng.normal(0, 1, (B, h, h, c)).astype(np.float32)
             for h, c in ((12, 64), (6, 128), (3, 256))]
    tfeats = [f + rng.normal(0, 0.3, f.shape).astype(np.float32) for f in feats]
    bits = [rng.uniform(2, 8, (B, h, w)).astype(np.float32) for h, w in ((4, 4), (2, 2), (1, 1))]

    def jterms(s, feats, bits):
        return jnp.stack([jl.kd_logit_loss(s, t), jl.kd_feature_loss(feats, tfeats),
                          jl.smoothness_loss(bits), jl.bit_budget_loss(
                              jnp.stack([b.mean() for b in bits]).mean(), 4.0)])

    ref = jterms(s, feats, bits)
    gs, gf, gb = jax.grad(lambda *a: (jterms(*a) * jnp.arange(1.0, 5.0)).sum(),
                          argnums=(0, 1, 2))(s, feats, bits)
    ts, tf, tb = ([_t(a, True) for a in x] for x in (s, feats, bits))
    terms = torch.stack([
        tl.kd_logit_loss(ts, [_t(a) for a in t]),
        tl.kd_feature_loss(tf, [_t(a) for a in tfeats]),
        tl.smoothness_loss(tb),
        tl.bit_budget_loss(torch.stack([b.mean() for b in tb]).mean(), 4.0)])
    (terms * torch.arange(1.0, 5.0)).sum().backward()
    _close(terms.detach().numpy(), ref)
    for xs, gs_ in ((ts, gs), (tf, gf), (tb, gb)):
        for a, g in zip(xs, gs_):
            _close(a.grad.numpy(), g)
    # a shape mismatch is skipped; nothing matched gives 0
    assert float(tl.kd_logit_loss(ts[:1], [_t(t[1])])) == 0.0
    assert float(jl.kd_logit_loss(s[:1], [t[1]])) == 0.0


@pytest.mark.parametrize("mode", ["softplus", "abs"])
def test_mapper_l2(mode):
    """Lreg sums the squares of the mapper's weight matrices: the raw theta
    in softplus mode, the Dense kernels in abs mode; never a BatchNorm
    scale or a bias."""
    jm = JaxMapper(monotone_param=mode)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(7), jnp.zeros((1, 4, 4)), training=False))
    port = ComplexityToBitMappingNetwork(monotone_param=mode)
    load_jax_variables(port, v)
    ref = jl.mapper_l2(v["params"])
    out = tl.mapper_l2(port)
    _close(out.item(), ref)
    assert float(tl.mapper_l2(None)) == 0.0


def test_mcaq_loss_total_and_terms():
    maps = _raw_maps(8)
    gt_boxes, gt_classes, gt_mask = _targets(8)
    teacher = _raw_maps(9)
    rng = np.random.default_rng(8)
    bits = [rng.uniform(2, 8, (B, h, w)).astype(np.float32) for h, w in ((4, 4), (2, 2), (1, 1))]
    weights = {"detection": 1.0, "bit_budget": 0.05, "smoothness": 0.02,
               "distillation": 0.5, "regularization": 1e-4}
    batch = {"gt_boxes": gt_boxes, "gt_classes": gt_classes, "gt_mask": gt_mask}

    def jtotal(maps, bits):
        aux = {"avg_bits": jnp.stack([b.mean() for b in bits]).mean(), "bit_map": bits,
               "kd_feature_loss": jnp.float32(0.25)}
        return jl.MCAQYOLOLoss(NC, 4.0)(maps, batch, aux, teacher_maps=teacher,
                                        loss_weights=weights, target_bits=5.0)

    (ref_total, ref_dict), (gm, gb) = jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True)(maps, bits)
    tm, tb = [_t(a, True) for a in maps], [_t(a, True) for a in bits]
    aux = {"avg_bits": torch.stack([b.mean() for b in tb]).mean(), "bit_map": tb,
           "kd_feature_loss": torch.tensor(0.25)}
    total, d = tl.MCAQYOLOLoss(NC, 4.0)(
        tm, {k: _t(v) for k, v in batch.items()}, aux, teacher_maps=[_t(t) for t in teacher],
        loss_weights=weights, target_bits=5.0)
    total.backward()
    _close(total.item(), ref_total)
    for k in ("loss_det", "loss_bit", "loss_smooth", "loss_kd", "loss_reg", "box_loss",
              "cls_loss", "dfl_loss"):
        _close(d[k].detach().item(), float(ref_dict[k]))
    for xs, gs in ((tm, gm), (tb, gb)):
        for a, g in zip(xs, gs):
            _close(a.grad.numpy(), g)
