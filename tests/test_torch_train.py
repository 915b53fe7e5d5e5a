"""The port's training path against the JAX reference on the CPU: the
quantizer's train branch and EMA state, BatchNorm in train mode, the bit
mapper's projection, the optimizer, the curriculum and one whole train
step (the Trainer's checkpoint is in `test_torch_train_checkpoint.py`).
Small size: yolov8n, 96 px, batch 2, nc 4, 8 box slots, inputs made from
numpy seeds.

Tolerances:
  * quantizer (fractional compose, soft mask): output and gradients w.r.t.
    x and the continuous bit map within 1e-5 of each array's largest
    magnitude; EMA statistics and `frozen` exact;
  * parameter gradients of a module (soft mask, bit mapper): every leaf
    within 1e-5 of the largest gradient magnitude over all its leaves (the
    Dense biases ahead of a BatchNorm have a true gradient of 0, so theirs
    is rounding noise);
  * BatchNorm running statistics after one train forward (C2f block and
    the mapper's BatchNorm1d over N = B*Ht*Wt tiles) within 1e-5 relative;
    outputs within 1e-4 (convolution summation order);
  * projection exact; the schedule within 1e-6 of the peak learning rate
    (optax evaluates it in float32); AdamW + clip + schedule + decay mask on
    identical gradients within 1e-6 of optax's parameters over 3 steps;
    curriculum values exactly equal;
  * whole step (forward in train mode, KD, Eq.20 loss, backward): loss
    terms within 1e-3 relative, per-group gradient relative L2 error within
    1e-2, BatchNorm statistics within 1e-2 and quantizer statistics within
    1e-4 of each array's largest magnitude.  This class is
    wider than the modules' because the network's inputs to them differ:
    convolution rounding moves a few features (0.01% at P3, 0.1% at P5)
    across a quantization step, and the 96 px P5 map sits on Canny gradient
    ties (ROADMAP C), which moves its complexity.  Measured: loss terms
    within 3.6e-4, gradients within 3.7e-3, BatchNorm statistics within
    1.4e-3, quantizer statistics within 2.6e-5.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mcaq_yolo_tpu.core import bit_allocation as jba
from mcaq_yolo_tpu.core.curriculum import CurriculumScheduler as JaxCurriculum
from mcaq_yolo_tpu.core.quantization import SpatialAdaptiveQuantization as JaxQuant
from mcaq_yolo_tpu.core.quantization import freeze_calibration as jax_freeze
from mcaq_yolo_tpu.models import MCAQYOLO as JaxMCAQYOLO
from mcaq_yolo_tpu.models import YOLOv8 as JaxYOLOv8
from mcaq_yolo_tpu.models.layers import C2f as JaxC2f
from mcaq_yolo_tpu.models.losses import MCAQYOLOLoss as JaxLoss
from mcaq_yolo_tpu.models.losses import kd_feature_loss as jax_kd_feature_loss
from mcaq_yolo_tpu.train import weight_decay_mask as jax_decay_mask
from mcaq_yolo_tpu_torch.core import bit_allocation as tba
from mcaq_yolo_tpu_torch.core.curriculum import CurriculumScheduler
from mcaq_yolo_tpu_torch.core.quantization import SpatialAdaptiveQuantization, freeze_calibration
from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
from mcaq_yolo_tpu_torch.models.layers import C2f, ConvBnSiLU
from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables, to_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8, init_weights
from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step, warmup_cosine_schedule

IMG, NC, B, MB = 96, 4, 2, 8


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = np.abs(a - b).max(), max(np.abs(b).max(), 1e-30)
    assert err <= rel * scale, f"max |diff| {err:.3g} > {rel} x {scale:.3g}"


def _rel_close(a, b, rel=1e-5):
    """Elementwise: |a - b| <= rel * |b| (+ a tiny floor for zeros)."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rel, atol=1e-12)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _close_grads(got, ref, rel=1e-5):
    """Every leaf within rel x the largest |ref| over all leaves."""
    ref = _flat(_np(ref))
    got = _flat(got)
    assert set(got) == set(ref)
    scale = max(np.abs(v).max() for v in ref.values())
    for name, val in ref.items():
        err = np.abs(got[name] - val).max()
        assert err <= rel * scale, f"{name}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


def _flat(tree):
    return dict(_leaves(tree))


def _grads_as_flax(model):
    """The model's .grad as a flax 'params' tree (zeros where None)."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, gp in zip(model.parameters(), g.parameters()):
            gp.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return to_jax_variables(g)["params"]


def _set_grads(model, grads, skip=()):
    """p.grad from a flax-layout gradient tree; names in `skip` get none."""
    g = copy.deepcopy(model)
    load_jax_variables(g, {"params": grads})
    for (name, p), gp in zip(model.named_parameters(), g.parameters()):
        p.grad = None if name in skip else gp.detach().clone()


# ---------------------------------------------------------------------------
# Quantizer: fractional compose, EMA state, freeze
# ---------------------------------------------------------------------------


def _quant_inputs(seed, C=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 16, 16, C)).astype(np.float32)
    bits = rng.uniform(2.0, 8.0, (B, 4, 4)).astype(np.float32)
    bits[0, 0, 0], bits[1, 3, 3], bits[0, 2, 1] = 8.0, 2.0, 5.0  # bmax, bmin, an integer
    return x, bits


def _quant_pair(seed):
    x, bits = _quant_inputs(seed)
    jq = JaxQuant()
    v = _np(jq.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(bits)))
    rng = np.random.default_rng(seed + 1)  # a soft mask far from its init
    v["params"]["soft_mask"]["Conv_1"]["bias"] = np.asarray([0.3, 0.0], np.float32)
    v["params"]["soft_mask"]["Conv_1"]["kernel"] = rng.normal(0, 0.5, (1, 1, 8, 2)).astype(
        np.float32)
    port = SpatialAdaptiveQuantization(8)
    load_jax_variables(port, v)
    return jq, v, port, x, bits


def test_fractional_compose_forward_and_gradients():
    jq, v, port, x, bits = _quant_pair(0)
    w = np.random.default_rng(9).normal(0, 1, x.shape).astype(np.float32)

    def jfn(params, x, bits):
        out, upd = jq.apply({**v, "params": params}, x, bits, training=True,
                            mutable=["quant_stats"])
        return (out * w).sum(), (out, upd)

    (_, (ref, upd)), (gp, gx, gb) = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        v["params"], jnp.asarray(x), jnp.asarray(bits))
    tx = torch.tensor(x, requires_grad=True)
    tb = torch.tensor(bits, requires_grad=True)
    out = port(tx, tb, training=True)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), ref)
    _close(tx.grad.numpy(), gx)
    _close(tb.grad.numpy(), gb)
    assert np.abs(np.asarray(gb)).max() > 0  # the bit map gets a gradient
    _close_grads(_grads_as_flax(port), gp)
    for name, val in _leaves(_np(upd["quant_stats"])):
        np.testing.assert_array_equal(_flat(to_jax_variables(port)["quant_stats"])[name], val)


def test_quantizer_ema_state_and_freeze():
    """Five calls: first batch (taken as-is), an EMA step, update_stats=False,
    an eval-mode calibration step, then frozen (state kept, range fixed)."""
    jq, v, port, _, bits = _quant_pair(1)
    stats = v["quant_stats"]
    calls = [dict(training=True), dict(training=True), dict(training=True, update_stats=False),
             dict(training=False, update_stats=True), "freeze",
             dict(training=True), dict(training=False, update_stats=True)]
    for i, kw in enumerate(calls):
        if kw == "freeze":
            stats = _np(jax_freeze(stats))
            freeze_calibration(port)
        else:
            x, _ = _quant_inputs(10 + i)
            b = bits if kw["training"] else np.round(bits)
            ref, upd = jq.apply({**v, "quant_stats": stats}, x, b, mutable=["quant_stats"], **kw)
            stats = _np(upd["quant_stats"])
            out = port(torch.from_numpy(x), torch.from_numpy(b), **kw)
            _close(out.detach().numpy(), ref)
        got = _flat(to_jax_variables(port)["quant_stats"])
        for name, val in _leaves(stats):
            np.testing.assert_array_equal(got[name], val, err_msg=f"call {i}: {name}")
    assert int(stats["num_batches"]) == 3 and bool(stats["frozen"])


# ---------------------------------------------------------------------------
# BatchNorm in train mode, mapper, projection, bit statistics
# ---------------------------------------------------------------------------


def test_batchnorm_running_stats_c2f_block():
    rng = np.random.default_rng(2)
    x = rng.normal(0.3, 1.2, (B, 12, 12, 16)).astype(np.float32)
    jb = JaxC2f(16, 1, True)
    v = _np(jb.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    for name, leaf in _leaves(v["batch_stats"]):  # non-trivial running statistics
        leaf[...] = rng.uniform(0.5, 1.5, leaf.shape) if name.endswith("var") else \
            rng.normal(0, 0.3, leaf.shape)
    ref, upd = jb.apply(v, jnp.asarray(x), training=True, mutable=["batch_stats"])
    port = C2f(16, 16, 1, True)
    load_jax_variables(port, v)
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2), training=True)
    _close(out.detach().permute(0, 2, 3, 1).numpy(), ref, rel=1e-4)
    got = _flat(to_jax_variables(port)["batch_stats"])
    for name, val in _leaves(_np(upd["batch_stats"])):
        _rel_close(got[name], val)
    # eval mode reads the running statistics and updates nothing
    before = to_jax_variables(port)["batch_stats"]
    port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, val in _leaves(before):
        np.testing.assert_array_equal(_flat(to_jax_variables(port)["batch_stats"])[name], val)


@pytest.mark.parametrize("mode", ["softplus", "abs"])
def test_mapper_train_mode(mode):
    """Continuous bits, gradients w.r.t. complexity and parameters, and the
    BatchNorm1d running statistics over the N = B*Ht*Wt tiles."""
    c = np.random.default_rng(3).uniform(0.05, 0.9, (B, 8, 8)).astype(np.float32)
    jm = jba.ComplexityToBitMappingNetwork(monotone_param=mode)
    v = _np(jm.init(jax.random.PRNGKey(3), jnp.asarray(c)))
    port = tba.ComplexityToBitMappingNetwork(monotone_param=mode)
    load_jax_variables(port, v)

    def jfn(params, c):
        out, upd = jm.apply({**v, "params": params}, c, 1.0, return_continuous=True,
                            training=True, mutable=["batch_stats"])
        return (out ** 2).sum(), (out, upd)

    (_, (ref, upd)), (gp, gc) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(c))
    tc = torch.tensor(c, requires_grad=True)
    out = port(tc, 1.0, return_continuous=True, training=True)
    (out ** 2).sum().backward()
    _close(out.detach().numpy(), ref)
    _close(tc.grad.numpy(), gc)
    _close_grads(_grads_as_flax(port), gp)
    got = _flat(to_jax_variables(port)["batch_stats"])
    for name, val in _leaves(_np(upd["batch_stats"])):
        _rel_close(got[name], val)


@pytest.mark.parametrize("mode", ["softplus", "abs"])
def test_enforce_monotonic_params(mode):
    """|.| of Dense kernels and BatchNorm scales; theta and biases kept."""
    jm = jba.ComplexityToBitMappingNetwork(monotone_param=mode)
    v = _np(jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 4, 4))))
    rng = np.random.default_rng(4)
    for _, leaf in _leaves(v["params"]):
        leaf[...] = rng.normal(0, 1, leaf.shape)
    port = tba.ComplexityToBitMappingNetwork(monotone_param=mode)
    load_jax_variables(port, v)
    tba.enforce_monotonic_params(port)
    ref = _np(jba.enforce_monotonic_params(v["params"]))
    got = _flat(to_jax_variables(port)["params"])
    for name, val in _leaves(ref):
        np.testing.assert_array_equal(got[name], val)
    assert any((val < 0).any() for _, val in _leaves(ref))  # something was left signed


def test_bit_statistics():
    bm = np.random.default_rng(5).uniform(1.6, 8.4, (B, 6, 6)).astype(np.float32)
    ref = jba.get_bit_statistics(jnp.asarray(bm))
    got = tba.get_bit_statistics(torch.from_numpy(bm))
    np.testing.assert_array_equal(got["histogram"].numpy(), np.asarray(ref["histogram"]))
    for k in ("mean", "std", "min", "max"):
        _close(float(got[k]), float(ref[k]))


# ---------------------------------------------------------------------------
# Optimizer and curriculum
# ---------------------------------------------------------------------------


def _jax_schedule(lr, warmup_steps, total_steps, eta_min):
    """The reference Trainer's schedule (mcaq_yolo_tpu/train.py:423-432)."""
    return optax.join_schedules(
        [optax.linear_schedule(lr * 0.01, lr, max(1, warmup_steps)),
         optax.cosine_decay_schedule(lr, max(1, total_steps - warmup_steps),
                                     alpha=eta_min / lr)],
        [warmup_steps])


def test_schedule_matches_optax():
    for lr, warm, total, eta in ((1e-3, 5, 40, 1e-6), (2e-3, 0, 10, 1e-5), (1e-3, 3, 3, 1e-6)):
        ours, ref = warmup_cosine_schedule(lr, warm, total, eta), _jax_schedule(lr, warm,
                                                                                total, eta)
        for step in range(total + 3):
            assert abs(ours(step) - float(ref(step))) <= 1e-6 * lr


@pytest.mark.parametrize("decay_bit_mapper", [False, True])
def test_adamw_clip_schedule_mask_vs_optax(decay_bit_mapper):
    """Three steps on identical gradients: global norms 3 (clipped), 0.5 and
    2 (clipped); in the third, one leaf has no gradient in the port and a
    zero one in optax (its decay and moments still move)."""
    model = torch.nn.Module()
    model.backbone = ConvBnSiLU(3, 8, 3)
    model.bit_mapper = tba.ComplexityToBitMappingNetwork(hidden_dims=(8,))
    init_weights(model, 0)
    params = to_jax_variables(model)["params"]
    sched = _jax_schedule(1e-2, 2, 10, 1e-6)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        sched, b1=0.9, b2=0.999, weight_decay=0.05,
        mask=lambda p: jax_decay_mask(p, decay_bit_mapper)))
    opt_state = tx.init(params)
    opt = Optimizer(model, warmup_cosine_schedule(1e-2, 2, 10, 1e-6),
                    decay_bit_mapper=decay_bit_mapper)
    rng = np.random.default_rng(6)
    for step, norm in enumerate((3.0, 0.5, 2.0)):
        grads = jax.tree_util.tree_map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32),
                                       params)
        total = math.sqrt(sum(float((g ** 2).sum()) for _, g in _leaves(grads)))
        grads = jax.tree_util.tree_map(lambda g: (g * (norm / total)).astype(np.float32), grads)
        skip = ()
        if step == 2:
            grads["backbone"]["BatchNorm_0"]["bias"][...] = 0.0
            skip = ("backbone.BatchNorm_0.bias",)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = _np(optax.apply_updates(params, updates))
        _set_grads(model, grads, skip)
        opt.step()
        got = _flat(to_jax_variables(model)["params"])
        for name, val in _leaves(params):
            np.testing.assert_allclose(got[name], val, rtol=0, atol=1e-6, err_msg=name)
    assert opt.step_count == 3


@pytest.mark.parametrize("kw", [
    {},
    {"warmup_epochs": 0, "transition_epochs": 0},
    {"curriculum_type": "linear", "lambda_bit_gate": False},
    {"curriculum_type": "cosine", "anneal_epochs": 150, "budget_anneal": "exp_exact"},
    {"curriculum_type": "step", "budget_controller": True},
])
def test_curriculum_schedule_equal(kw):
    ours, ref = CurriculumScheduler(**kw), JaxCurriculum(**kw)
    rng = np.random.default_rng(7)
    for e in range(300):
        for fn in ("get_stage", "get_complexity_threshold", "get_temperature",
                   "get_effective_temperature", "get_target_bits", "get_bit_budget_gate",
                   "get_loss_weights", "should_update_bit_allocation"):
            assert getattr(ours, fn)(e) == getattr(ref, fn)(e), (fn, e)
        measured = float(rng.uniform(2, 8))
        assert ours.update_budget_controller(measured, e) == \
            ref.update_budget_controller(measured, e)
        ours.step()
        ref.step()
        assert ours.get_current_params() == ref.get_current_params()


# ---------------------------------------------------------------------------
# One whole train step against the JAX step
# ---------------------------------------------------------------------------

LW = {"detection": 1.0, "bit_budget": 0.05, "smoothness": 0.1, "distillation": 0.5,
      "regularization": 1e-4}


@pytest.fixture(scope="module")
def step_pair():
    """The JAX step's loss terms, gradients and updated statistics, and the
    port's train step on the same weights and batch (Stage 3: quantize on,
    temperature 1, KD on).  The port's optimizer has lr 0 (weights kept);
    the gradients it leaves (clipped to norm 1) are scaled back by the
    global norm the step returns."""
    batch = synthetic_batches(1, B, IMG, NC, max_boxes=MB, boxes_per_image=(3, 6), seed=0)[0]
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=NC, morph_downsample=2)
    v = _np(jax.jit(lambda k, x: jm.init(k, x, training=False))(
        jax.random.PRNGKey(0), jnp.asarray(batch["image"][:1])))
    teacher = JaxYOLOv8("yolov8n", NC)
    tv = _np(jax.jit(teacher.init)(jax.random.PRNGKey(1), jnp.asarray(batch["image"][:1])))
    loss_obj = JaxLoss(NC, 4.0)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}

    def loss_fn(params, v, tv, jbatch):  # mcaq_yolo_tpu/train.py:97-137
        (raw, aux), upd = jm.apply({**v, "params": params}, jbatch["image"], temperature=1.0,
                                   quantize=True, training=True,
                                   mutable=["batch_stats", "quant_stats"])
        tmaps = teacher.apply(tv, jbatch["image"])
        aux["kd_feature_loss"] = jax_kd_feature_loss(
            aux["quantized_features"], teacher.apply(tv, jbatch["image"], method="features"))
        total, d = loss_obj(raw, jbatch, aux, teacher_maps=tmaps,
                            mapper_params=params.get("bit_mapper"), loss_weights=LW,
                            target_bits=4.0)
        return total, (d, upd, aux["bit_map"])

    (_, (ref_d, ref_upd, ref_bits)), ref_g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v["params"], v, tv, jbatch)

    model = load_jax_variables(MCAQYOLO(num_classes=NC, morph_downsample=2, device="cpu"), v)
    port_teacher = load_jax_variables(YOLOv8("yolov8n", NC, device="cpu"), tv)
    step = make_train_step(model, MCAQYOLOLoss(NC, 4.0), port_teacher)
    metrics = step(Optimizer(model, lambda s: 0.0),
                   {k: torch.from_numpy(a) for k, a in batch.items()}, 1.0, 4.0,
                   LW["bit_budget"], LW["smoothness"], LW["distillation"],
                   LW["regularization"], quantize=True, use_kd=True)
    with torch.no_grad():
        for p in model.parameters():
            p.grad.mul_(max(float(metrics["grad_norm"]), 1.0))
    return (_np(ref_d), _np(ref_upd), _np(ref_g), [np.asarray(b) for b in ref_bits],
            metrics, model)


def test_whole_step_loss_terms(step_pair):
    ref_d, _, _, ref_bits, metrics, _ = step_pair
    for k in ("loss_total", "loss_det", "box_loss", "cls_loss", "dfl_loss", "loss_bit",
              "loss_smooth", "loss_kd", "loss_reg"):
        assert float(metrics[k]) == pytest.approx(float(ref_d[k]), rel=1e-3), k
    assert int(metrics["num_fg"]) == int(ref_d["num_fg"]) > 0
    assert 2.0 <= float(metrics["avg_bits"]) <= 8.0
    hist = np.bincount((np.clip(np.round(np.concatenate([b.ravel() for b in ref_bits])),
                                2, 8) - 2).astype(int), minlength=7)
    np.testing.assert_array_equal(metrics["bit_hist"].numpy(), hist)


def test_whole_step_gradients(step_pair):
    """Relative L2 error of the gradient per top-level group (backbone, neck,
    head, complexity analyzer, bit mapper, the three quantizers' soft
    masks); every group gets a nonzero gradient."""
    _, _, ref_g, _, _, model = step_pair
    got = _grads_as_flax(model)
    assert set(got) == set(ref_g)
    for group in ref_g:
        a = np.concatenate([g.ravel() for _, g in _leaves(got[group])])
        b = np.concatenate([g.ravel() for _, g in _leaves(ref_g[group])])
        assert np.linalg.norm(b) > 0, group
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= 1e-2, f"{group}: relative L2 error {err:.3g}"


def test_whole_step_statistics(step_pair):
    _, ref_upd, _, _, _, model = step_pair
    for col in ("batch_stats", "quant_stats"):
        got = _flat(to_jax_variables(model)[col])
        for name, val in _leaves(ref_upd[col]):
            if val.dtype.kind == "f":
                _close(got[name], val, rel=1e-2 if col == "batch_stats" else 1e-4)
            else:
                np.testing.assert_array_equal(got[name], val, err_msg=name)
