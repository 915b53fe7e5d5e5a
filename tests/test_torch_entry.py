"""The port's entry points (`mcaq_yolo_tpu_torch/entry.py`) against the JAX
package's (`__graft_entry__.py`) on the CPU.

  * `entry(device="cpu")`: the JAX entry's model settings (read from the
    JAX `MCAQYOLO` constructor: `__graft_entry__.entry` itself probes a TPU
    backend) and its (4, 640, 640, 3) zero images in the port's layout;
    `fn` equal to the JAX entry's `fn` body (`model.apply(..., temperature=
    1.0, quantize=True, training=False)`) at 64 px, batch 2, on seeded
    images, with JAX-initialised weights carried across: raw maps within
    2e-4 on >= 99.9% of elements and avg_bits within 1e-6 relative (the
    deployed slice's tolerances, tests/test_torch_slice.py).
  * `dryrun_multichip(2, device="cpu")` (two spawned gloo ranks) on JAX's
    dryrun weights: its three lines; the DP step's loss within 1e-3
    relative of JAX's same program on a 2-device CPU mesh (the port-against-
    JAX class of tests/test_torch_train.py); the DP serving avg_bits within
    1e-6 relative of JAX's serving program on the weights the port's DP
    step left; the FSDP fraction equal to JAX's `shard_fraction` of the same
    train-state tree; the ranks' replicated leaves equal after FSDP.
  * the port's own starting state (`init_state`) has JAX's layout.
  * without CUDA, `entry()` and `dryrun_multichip()` raise.

Both modules are built once; one torch thread is pinned for the module.
"""

import contextlib
import io
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mcaq_yolo_tpu.core.bit_allocation import enforce_monotonic_params as jax_enforce
from mcaq_yolo_tpu.models import MCAQYOLO as JaxMCAQYOLO
from mcaq_yolo_tpu.models import YOLOv8 as JaxYOLOv8
from mcaq_yolo_tpu.models.losses import MCAQYOLOLoss as JaxLoss
from mcaq_yolo_tpu.models.yolo import decode_and_nms as jax_decode_and_nms
from mcaq_yolo_tpu.parallel import fsdp as jfsdp
from mcaq_yolo_tpu.parallel import mesh as jmesh
from mcaq_yolo_tpu.train import TrainState
from mcaq_yolo_tpu.train import make_train_step as jax_make_train_step
from mcaq_yolo_tpu_torch import entry as port_entry
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables

RANKS = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def entry_pair(one_thread):
    """(the port's fn, model and images; JAX's model and variables)."""
    fn, (model, images) = port_entry.entry(device="cpu")
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=80, bit_mapping="mlp")
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = _np(jax.jit(lambda k, x: jm.init(k, x, training=False))(jax.random.PRNGKey(0), x))
    return fn, model, images, jm, v


def test_entry_example_args_match_jax(entry_pair):
    _, model, images, jm, _ = entry_pair
    # __graft_entry__.py:69-70: zeros (4, 640, 640, 3) float32
    assert tuple(images.permute(0, 2, 3, 1).shape) == (4, 640, 640, 3)
    assert images.dtype == torch.float32 and images.device.type == "cpu"
    assert images.is_contiguous(memory_format=torch.channels_last)
    assert not images.any()
    for name in ("variant", "num_classes", "min_bits", "max_bits", "target_bits",
                 "grid_size", "bit_mapping", "monotone_param", "normalize_complexity",
                 "morph_downsample", "morph_tile_engine"):
        assert getattr(model, name) == getattr(jm, name), name
    assert jm.dtype == jnp.float32 and model.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not model.training
    assert [q.calibration_mode for q in model.quantizers] == [jm.calibration_mode] * 3


def test_entry_fn_equals_jax(entry_pair):
    fn, model, _, jm, v = entry_pair
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    raw_ref, aux_ref = jax.jit(partial(jm.apply, temperature=1.0, quantize=True,
                                       training=False))(v, jnp.asarray(x))
    load_jax_variables(model, v)
    images = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last, as entry() makes them
    assert images.is_contiguous(memory_format=torch.channels_last)
    raw, avg_bits = fn(model, images)
    assert float(avg_bits) == pytest.approx(float(aux_ref["avg_bits"]), rel=1e-6)
    for o, r in zip(raw, raw_ref):
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == r.shape and np.isfinite(o).all()
        close = np.abs(o - r) <= 2e-4 + 2e-4 * np.abs(r)
        assert close.mean() >= 0.999, f"only {close.mean():.5f} of raw-map elements within 2e-4"


# ---------------------------------------------------------------------------
# dryrun_multichip()
# ---------------------------------------------------------------------------


def _jax_program(n):
    """JAX's dryrun programs (`__graft_entry__.py:82-224`) on an n-device
    mesh: the starting variables, the DP step's metrics, and the serving
    function of variables."""
    img, nc = port_entry.IMG, port_entry.NC
    model = JaxMCAQYOLO(variant="yolov8n", num_classes=nc, bit_mapping="mlp", grid_size=4)
    teacher = JaxYOLOv8("yolov8n", nc)
    dummy = jnp.zeros((1, img, img, 3), jnp.float32)
    variables = _np(jax.jit(lambda k, x: model.init(k, x, training=True))(
        jax.random.PRNGKey(0), dummy))
    teacher_vars = _np(jax.jit(teacher.init)(jax.random.PRNGKey(1), dummy))
    params = dict(variables["params"])
    params["bit_mapper"] = _np(jax_enforce(params["bit_mapper"]))
    variables = dict(variables, params=params)

    mesh = jmesh.make_mesh(n)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    state = jmesh.replicate(mesh, TrainState.create(
        apply_fn=model.apply, params=params, tx=tx, batch_stats=variables["batch_stats"],
        quant_stats=variables["quant_stats"], buffers=variables.get("buffers", {})))
    batch = jmesh.shard_batch(mesh, {k: jnp.asarray(a)
                                     for k, a in port_entry.dryrun_batch(n).items()})
    step = jax_make_train_step(model, JaxLoss(nc, 4.0), teacher)
    _, metrics = step(state, batch, jmesh.replicate(mesh, teacher_vars),
                      *[jnp.float32(a) for a in port_entry.STEP_ARGS],
                      quantize=True, use_kd=True)

    @partial(jax.jit, in_shardings=(jmesh.replicate_sharding(mesh), jmesh.batch_sharding(mesh)))
    def serve(v, images):
        raw, aux = model.apply(v, images, temperature=1.0, quantize=True, training=False)
        return jax_decode_and_nms(raw, nc, max_det=32, pre_topk=64) + (aux["avg_bits"],)

    return variables, teacher_vars, _np(metrics), (lambda v: serve(v, batch["image"])), mesh


@pytest.fixture(scope="module")
def dryrun_pair(one_thread):
    variables, teacher_vars, jax_metrics, jax_serve, mesh = _jax_program(RANKS)
    state = {"student": variables, "teacher": teacher_vars, "opt_state": None, "step": 0}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = port_entry.dryrun_multichip(RANKS, device="cpu", state=state)
    return result, out.getvalue(), jax_metrics, jax_serve, mesh, state


def _three_lines(printed, n):
    lines = [ln for ln in printed.splitlines() if ln.startswith("[dryrun_multichip]")]
    assert len(lines) == 3, printed
    assert lines[0].startswith(f"[dryrun_multichip] {n}-device DP step OK: loss=")
    assert lines[1].startswith(f"[dryrun_multichip] {n}-device DP serving (decode+NMS) OK: "
                               "avg_bits=")
    assert lines[2].startswith(f"[dryrun_multichip] {n}-device FSDP step OK: loss=")
    assert lines[2].endswith("% of state elements sharded)")
    return lines


def test_dryrun_prints_the_three_lines(dryrun_pair):
    result, printed, *_ = dryrun_pair
    lines = _three_lines(printed, RANKS)
    assert f"loss={result['dp']['loss']:.4f}" in lines[0]
    assert f"avg_bits={result['serving']['avg_bits']:.2f}" in lines[1]
    assert f"({result['fsdp']['fraction']:.0%} of" in lines[2]
    assert result["serving"]["boxes_shape"] == (RANKS, port_entry.MAX_DET, 4)
    assert result["fsdp"]["replicated_equal"]
    assert len(result["launches_per_rank"]) == RANKS


def test_dryrun_dp_step_loss_equals_jax(dryrun_pair):
    result, _, jax_metrics, *_ = dryrun_pair
    assert result["dp"]["loss"] == pytest.approx(float(jax_metrics["loss_total"]), rel=1e-3)
    assert result["dp"]["avg_bits"] == pytest.approx(float(jax_metrics["avg_bits"]), rel=1e-3)


def test_dryrun_serving_avg_bits_equals_jax(dryrun_pair):
    result, _, _, jax_serve, *_ = dryrun_pair
    after = result["state_after_dp"]["student"]
    v = {c: after[c] for c in ("params", "batch_stats", "quant_stats", "buffers") if c in after}
    boxes, _, _, _, avg_bits = jax_serve(v)
    assert tuple(boxes.shape) == result["serving"]["boxes_shape"]
    assert result["serving"]["avg_bits"] == pytest.approx(float(avg_bits), rel=1e-6)


def test_dryrun_fsdp_fraction_equals_jax_rule(dryrun_pair):
    result, _, _, _, mesh, _ = dryrun_pair
    tree = port_entry.train_state_tree(result["state_after_dp"])
    assert result["fsdp"]["fraction"] == jfsdp.shard_fraction(tree, mesh)
    assert result["fsdp"]["fraction"] > 0.5


def test_init_state_has_the_jax_dryrun_state_layout(dryrun_pair):
    """The port's own starting state (the dryrun's default) holds the leaves
    and shapes of JAX's, with the bit mapper already projected by Eq.18."""
    jax_state = dryrun_pair[-1]
    state = port_entry.init_state("cpu")
    for part in ("student", "teacher"):
        shapes = jax.tree_util.tree_map(np.shape, state[part])
        assert shapes == jax.tree_util.tree_map(np.shape, jax_state[part]), part
    mapper = state["student"]["params"]["bit_mapper"]
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, mapper,
                                                         _np(jax_enforce(mapper))))
    assert state["opt_state"] is None and state["step"] == 0


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    for call in (port_entry.entry, lambda: port_entry.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
