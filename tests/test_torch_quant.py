"""The port's spatial quantizer (`mcaq_yolo_tpu_torch/ops/spatial_quant.py`,
`core/quantization.py`) against the JAX reference on the CPU.

Same inputs (numpy, seeded) through both.  Contracts:
  * the plain version of the CUDA kernel is BITWISE equal to the
    reference's eval compose (`_compose_integer`, x mask) and to
    `spatial_quantize_reference` on exact tile multiples;
  * against the Pallas kernel (interpret mode, reciprocal-multiply
    arithmetic) it meets the existing `assert_quant_parity` contract;
  * on a non-multiple shape it is bitwise equal to `_compose_integer`
    (both use the floor(i * Ht / H) tile rule; the Pallas kernel clamps
    remainder pixels into the last tile instead);
  * the whole quantizer module (soft mask included) is within 1e-6 abs of
    the JAX module: the mask's 5x5 blur and per-tile means sum in another
    order than XLA's.
The CUDA kernel itself runs only on a GPU (`tests/test_torch_gpu.py` and
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_quant import assert_quant_parity

from mcaq_yolo_tpu.core.quantization import SpatialAdaptiveQuantization as JaxQuant
from mcaq_yolo_tpu.ops.pallas_quant import (
    precompute_qparams as jax_precompute_qparams,
    spatial_quantize_pallas,
    spatial_quantize_reference,
)
from mcaq_yolo_tpu_torch.core.quantization import SpatialAdaptiveQuantization
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables
from mcaq_yolo_tpu_torch.ops import spatial_quant as sq


def _inputs(B=2, H=16, W=16, C=8, Ht=4, Wt=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    bit_map = rng.integers(2, 9, (B, Ht, Wt)).astype(np.float32)
    mask = rng.uniform(0.9, 1.0, (B, H, W)).astype(np.float32)
    return x, bit_map, x.min(axis=(0, 1, 2)), x.max(axis=(0, 1, 2)), mask


def _jax_compose(x, bit_map, x_min, x_max, mask=None, dtype=jnp.float32):
    """The reference eval path: _compose_integer on f32, x mask, cast."""
    xj = jnp.asarray(x, dtype)
    out = JaxQuant(smooth_transitions=False)._compose_integer(
        xj.astype(jnp.float32), jnp.asarray(bit_map), jnp.asarray(x_min), jnp.asarray(x_max))
    if mask is not None:
        out = out * jnp.asarray(mask)[..., None]
    return np.asarray(out.astype(dtype).astype(jnp.float32))


def _port(x, bit_map, x_min, x_max, mask=None, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = sq.spatial_quantize(t(x).to(dtype), t(bit_map), t(x_min), t(x_max),
                              None if mask is None else t(mask))
    assert out.dtype == dtype
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_bitwise_vs_compose_and_reference(C, with_mask):
    x, bit_map, x_min, x_max, mask = _inputs(C=C, seed=C)
    m = mask if with_mask else None
    out = _port(x, bit_map, x_min, x_max, m)
    np.testing.assert_array_equal(out, _jax_compose(x, bit_map, x_min, x_max, m))
    ref = spatial_quantize_reference(jnp.asarray(x), jnp.asarray(bit_map), jnp.asarray(x_min),
                                     jnp.asarray(x_max), None if m is None else jnp.asarray(m))
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_plain_bitwise_bf16():
    """bf16 I/O, f32 math: equal to the reference's compose on the bf16 map."""
    x, bit_map, _, _, mask = _inputs(C=16, seed=3)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    lo, hi = xb.min(axis=(0, 1, 2)), xb.max(axis=(0, 1, 2))
    out = _port(xb, bit_map, lo, hi, mask, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        out, _jax_compose(xb, bit_map, lo, hi, mask, dtype=jnp.bfloat16))


@pytest.mark.parametrize("C,with_mask", [(8, False), (8, True), (64, True)])
def test_plain_vs_pallas_interpret(C, with_mask):
    """C=64 takes the Pallas kernel's lane-packed call site."""
    x, bit_map, x_min, x_max, mask = _inputs(C=C, seed=10 + C)
    m = mask if with_mask else None
    out = _port(x, bit_map, x_min, x_max, m)
    ker = spatial_quantize_pallas(jnp.asarray(x), jnp.asarray(bit_map), jnp.asarray(x_min),
                                  jnp.asarray(x_max), None if m is None else jnp.asarray(m),
                                  interpret=True)
    assert_quant_parity(out, ker, jnp.asarray(bit_map), jnp.asarray(x_min),
                        jnp.asarray(x_max), 16, 16)


def test_plain_non_multiple_shape_bitwise():
    """H=W=12 over a 5x5 tile grid: floor(i * Ht / H) tile rule."""
    x, bit_map, x_min, x_max, _ = _inputs(H=12, W=12, C=4, Ht=5, Wt=5, seed=7)
    out = _port(x, bit_map, x_min, x_max)
    np.testing.assert_array_equal(out, _jax_compose(x, bit_map, x_min, x_max))


def test_precompute_qparams_matches_reference():
    _, _, x_min, x_max, _ = _inputs(C=8, seed=4)
    ours = sq.precompute_qparams(torch.from_numpy(x_min), torch.from_numpy(x_max))
    ref = jax_precompute_qparams(jnp.asarray(x_min), jnp.asarray(x_max))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_wrapper_cpu_uses_plain_and_counts_nothing():
    x, bit_map, x_min, x_max, mask = _inputs(C=8, seed=5)
    before = sq.spatial_quantize.launches
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    a = sq.spatial_quantize(t(x), t(bit_map), t(x_min), t(x_max), t(mask))
    b = sq.spatial_quantize_torch(t(x), t(bit_map), t(x_min), t(x_max), t(mask))
    assert torch.equal(a, b)
    assert sq.spatial_quantize.launches == before


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sq.spatial_quantize(x, torch.zeros((1, 1, 1), device="meta"),
                            torch.zeros(8, device="meta"), torch.zeros(8, device="meta"))


def _module_pair(C, frozen, seed):
    x, bit_map, x_min, x_max, _ = _inputs(B=2, H=16, W=16, C=C, seed=seed)
    jq = JaxQuant()
    v = jq.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(bit_map), training=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    if frozen:
        rng = np.random.default_rng(seed + 1)
        v["quant_stats"] = {
            "running_min": (x_min * rng.uniform(0.5, 0.9, C)).astype(np.float32),
            "running_max": (x_max * rng.uniform(0.5, 0.9, C)).astype(np.float32),
            "num_batches": np.asarray(7, np.int32),
            "frozen": np.asarray(True),
        }
    # a non-trivial mask: soft-mask logits far from the [4, 0] init
    v["params"]["soft_mask"]["Conv_1"]["bias"] = np.asarray([0.3, 0.0], np.float32)
    v["params"]["soft_mask"]["Conv_1"]["kernel"] = (
        np.random.default_rng(seed).normal(0, 0.5, (1, 1, 8, 2)).astype(np.float32))
    port = SpatialAdaptiveQuantization(C)
    load_jax_variables(port, v)
    ref = np.asarray(jq.apply(v, jnp.asarray(x), jnp.asarray(bit_map), training=False))
    out = port(torch.from_numpy(x), torch.from_numpy(bit_map)).numpy()
    return out, ref


@pytest.mark.parametrize("frozen", [False, True])
def test_quantizer_module_matches_jax(frozen):
    out, ref = _module_pair(C=16, frozen=frozen, seed=21 + int(frozen))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
