"""The port's four calibration modes, per-bit range rows and learned rounding
(`mcaq_yolo_tpu_torch/core/quantization.py`, `ops/spatial_quant.py`) against
the JAX quantizer on the CPU, on the same seeded numpy features and state.

Tolerances, each measured:
  * minmax: ranges and quantized maps bitwise;
  * percentile: ranges within one float32 ulp (2.4e-7 at |x| < 4; measured:
    2 of 16 values one ulp apart, XLA contracts the interpolation
    low * (1 - f) + high * f into a fused multiply-add), maps bitwise with
    the same ranges;
  * entropy: the batch histogram and its EMA bitwise, the searchsorted
    indices equal, ranges and maps bitwise;
  * mse: the chosen alpha index equal for every bit width on inputs whose
    error minimum is separated from the next candidate by more than 1e-5
    relative (checked in float64 here, measured 4.8e-5 at the closest; the
    reduction noise of a float32 mean over 12,800 values is ~1e-6, and the
    two packages sum in different orders), the ranges within one ulp of alpha
    (jnp.linspace is evaluated by XLA with a reciprocal: 21 of the 100
    candidates differ by one ulp);
  * per-bit rows through the plain version of the kernel: bitwise equal to
    the reference's 7-plane `_compose_integer` branch, f32 and bf16, with
    and without the soft mask;
  * EMA state after 3 update steps (the third on a frozen quantizer):
    running min / max, counts, flags and the histogram bitwise;
  * a flax-written entropy-mode quantizer checkpoint loads into the port and
    writes back bitwise;
  * LearnedRoundingQuantization bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mcaq_yolo_tpu.core.quantization import (
    LearnedRoundingQuantization as JaxRounding,
    SpatialAdaptiveQuantization as JaxQuant,
)
from mcaq_yolo_tpu_torch.core import quantization as Q
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables, to_jax_variables
from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
from mcaq_yolo_tpu_torch.utils.checkpoint import load_checkpoint, write_msgpack

C = 8
ULP4 = 2.4e-7  # one float32 ulp at 2 <= |x| < 4


def _features(seed, shape=(4, 40, 40, C), bits=(10, 10)):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    bit_map = rng.integers(2, 9, (shape[0],) + bits).astype(np.float32)
    mask = rng.uniform(0.5, 1.0, shape[:3]).astype(np.float32)
    return x, bit_map, mask


def _jax_range(mode, x, hist=None):
    jq = JaxQuant(calibration_mode=mode)
    z = jnp.zeros(C)
    return jq._calibration_range(jnp.asarray(x), z, z, jnp.asarray(0, jnp.int32),
                                 jnp.asarray(False), hist, False)


def _jax_map(x, bit_map, lo, hi, mask=None, dtype=jnp.float32):
    """The reference's eval compose on f32 x (7-plane for per-bit rows),
    times the mask, cast to the working dtype."""
    out = JaxQuant(smooth_transitions=False)._compose_integer(
        jnp.asarray(x, dtype).astype(jnp.float32), jnp.asarray(bit_map), jnp.asarray(lo),
        jnp.asarray(hi))
    if mask is not None:
        out = out * jnp.asarray(mask)[..., None]
    return np.asarray(out.astype(dtype).astype(jnp.float32))


def _port_map(x, bit_map, lo, hi, mask=None, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = sq.spatial_quantize(t(x).to(dtype), t(bit_map), t(lo), t(hi),
                              None if mask is None else t(mask))
    return out.to(torch.float32).numpy()


def test_minmax_range_and_map_bitwise():
    x, bit_map, mask = _features(1)
    lo, hi = _jax_range("minmax", x)
    q = Q.SpatialAdaptiveQuantization(C, smooth_transitions=False)
    plo, phi = q.calibration_range(torch.from_numpy(x))
    np.testing.assert_array_equal(plo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(hi))
    out = q(torch.from_numpy(x), torch.from_numpy(bit_map)).numpy()
    np.testing.assert_array_equal(out, _jax_map(x, bit_map, lo, hi))


@pytest.mark.parametrize("shape", [(4, 40, 40, C), (2, 16, 16, C)])
def test_percentile_range_within_an_ulp(shape):
    x, bit_map, mask = _features(2, shape, (shape[1] // 4,) * 2)
    lo, hi = (np.asarray(v) for v in _jax_range("percentile", x))
    q = Q.SpatialAdaptiveQuantization(C, calibration_mode="percentile", smooth_transitions=False)
    plo, phi = (v.numpy() for v in q.calibration_range(torch.from_numpy(x)))
    assert plo.shape == phi.shape == (C,)
    np.testing.assert_allclose(plo, lo, rtol=0, atol=ULP4)
    np.testing.assert_allclose(phi, hi, rtol=0, atol=ULP4)
    # the module's map is the compose with its own ranges, bitwise
    out = q(torch.from_numpy(x), torch.from_numpy(bit_map)).numpy()
    np.testing.assert_array_equal(out, _jax_map(x, bit_map, plo, phi))


def test_percentile_matches_jnp_quantile_and_passes_nan():
    """The float32 position q (n - 1), not numpy's float64 one: against
    jnp.quantile within one ulp at several positions."""
    rng = np.random.default_rng(3)
    flat = rng.normal(0, 1, (5000, 4)).astype(np.float32)
    for qv in (0.0001, 0.25, 0.9999):
        ref = np.asarray(jnp.quantile(jnp.asarray(flat), qv, axis=0))
        got = Q.channel_quantile(torch.from_numpy(flat), qv).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=ULP4)
    flat[7, 2] = np.nan
    got = Q.channel_quantile(torch.from_numpy(flat), 0.5).numpy()
    assert np.isnan(got[2]) and np.isfinite(np.delete(got, 2)).all()


def test_entropy_histogram_indices_and_range():
    x, bit_map, _ = _features(4)
    jq = JaxQuant(calibration_mode="entropy")
    h = np.asarray(jq._batch_histogram(jnp.asarray(x)))
    ph = Q.batch_histogram(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ph, h)
    # a skewed EMA histogram, so the central mass sits off the middle
    hist = np.convolve(h, np.ones(9) / 9, "same").astype(np.float32) ** 2
    hist = (hist / hist.sum()).astype(np.float32)
    lo, hi = (np.asarray(v) for v in _jax_range("entropy", x, jnp.asarray(hist)))
    q = Q.SpatialAdaptiveQuantization(C, calibration_mode="entropy", smooth_transitions=False)
    q.histogram.copy_(torch.from_numpy(hist))
    plo, phi = (v.numpy() for v in q.calibration_range(torch.from_numpy(x)))
    cum = np.cumsum(hist.astype(np.float64))
    idx = np.searchsorted(cum, [0.0005, 0.9995])
    absmax = np.abs(x).max()
    np.testing.assert_array_equal(np.round(-plo[0] / absmax * 2048), idx[0])
    np.testing.assert_array_equal(np.round(phi[0] / absmax * 2048), idx[1])
    np.testing.assert_array_equal(plo, lo)
    np.testing.assert_array_equal(phi, hi)
    out = q(torch.from_numpy(x), torch.from_numpy(bit_map)).numpy()
    np.testing.assert_array_equal(out, _jax_map(x, bit_map, lo, hi))


def _mse_errors64(x, alphas):
    """float64 reconstruction errors (7, 100) of the reference's grid."""
    x64 = x.astype(np.float64).ravel()
    lo, hi = x64.min(), x64.max()
    out = np.empty((7, len(alphas)))
    for i, b in enumerate(range(2, 9)):
        qmin, qmax = -2.0 ** (b - 1), 2.0 ** (b - 1) - 1
        for j, a in enumerate(alphas.astype(np.float64)):
            scale = max(hi * a - lo * a, 1e-8) / (qmax - qmin)
            zp = np.clip(qmin - lo * a / scale, qmin, qmax)
            q = np.clip(np.round(x64 / scale + zp), qmin, qmax)
            out[i, j] = np.mean((x64 - (q - zp) * scale) ** 2)
    return out


def test_mse_alphas_and_per_bit_ranges():
    x, bit_map, mask = _features(5, (2, 40, 40, 4), (10, 10))
    x[0, :4, :4] *= 3.0  # a few outliers: the small bit widths clip them
    jalphas = np.asarray(jnp.linspace(0.8, 1.0, 100))
    palphas = Q.mse_alphas().numpy()
    np.testing.assert_allclose(palphas, jalphas, rtol=1.2e-7, atol=0)
    errs = np.sort(_mse_errors64(x, jalphas), axis=1)
    # well separated: the smallest relative gap here is 4.8e-5 (7 bits)
    assert ((errs[:, 1] - errs[:, 0]) / errs[:, 0] > 1e-5).all()
    jlo, jhi = (np.asarray(v) for v in JaxQuant(calibration_mode="mse")._calibrate_mse(
        jnp.asarray(x)))
    plo, phi = (v.numpy() for v in Q.calibrate_mse(torch.from_numpy(x), chunk_elements=3000))
    assert plo.shape == phi.shape == (7, 1)
    xmin, xmax = x.min(), x.max()
    j_idx = [int(np.argmin(np.abs(jalphas - v))) for v in (jlo[:, 0] / xmin)]
    p_idx = [int(np.argmin(np.abs(palphas - v))) for v in (plo[:, 0] / xmin)]
    assert j_idx == p_idx and len(set(p_idx)) > 1, (j_idx, p_idx)
    np.testing.assert_allclose(plo, jlo, rtol=1.2e-7, atol=0)
    np.testing.assert_allclose(phi, jhi, rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(phi, xmax * palphas[p_idx][:, None])
    # the module in mse mode hands the (7, 1) rows to the kernel's wrapper
    q = Q.SpatialAdaptiveQuantization(4, calibration_mode="mse", smooth_transitions=False)
    out = q(torch.from_numpy(x), torch.from_numpy(bit_map)).numpy()
    np.testing.assert_array_equal(out, _jax_map(x, bit_map, plo, phi))


@pytest.mark.parametrize("rows", ["per-channel", "global"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_per_bit_rows_bitwise_vs_seven_plane_compose(rows, dtype, with_mask):
    x, bit_map, mask = _features(6, (2, 16, 16, C), (4, 4))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    rng = np.random.default_rng(7)
    width = C if rows == "per-channel" else 1
    lo = (x.min() * rng.uniform(0.5, 1.0, (7, width))).astype(np.float32)
    hi = (x.max() * rng.uniform(0.5, 1.0, (7, width))).astype(np.float32)
    m = mask if with_mask else None
    out = _port_map(x, bit_map, lo, hi, m, tdt)
    np.testing.assert_array_equal(out, _jax_map(x, bit_map, lo, hi, m, jdt))
    x = np.array(x)  # writable
    plain = sq.spatial_quantize_torch(torch.from_numpy(x).to(tdt), torch.from_numpy(bit_map),
                                      torch.from_numpy(lo), torch.from_numpy(hi),
                                      None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(plain.float().numpy(), out)


def test_per_bit_rows_checked_by_the_wrapper():
    x, bit_map, _ = _features(8, (1, 8, 8, C), (2, 2))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    with pytest.raises(ValueError, match="x_min/x_max"):
        sq._check(t(x), t(bit_map), t(np.zeros((6, C), np.float32)),
                  t(np.zeros((6, C), np.float32)), None)
    assert sq._check(t(x), t(bit_map), t(np.zeros((7, C), np.float32)),
                     t(np.ones((7, C), np.float32)), None) == (1, 8, 8, C, 2, 2)


@pytest.mark.parametrize("mode", Q.CALIBRATION_MODES)
def test_ema_state_after_three_update_steps(mode):
    rng = np.random.default_rng(9)
    xs = [rng.normal(0, 1 + i, (2, 16, 16, C)).astype(np.float32) for i in range(3)]
    bit_map = rng.integers(2, 9, (2, 4, 4)).astype(np.float32)
    jq = JaxQuant(calibration_mode=mode, smooth_transitions=False)
    v = jax.tree_util.tree_map(np.asarray, jq.init(
        jax.random.PRNGKey(0), jnp.asarray(xs[0]), jnp.asarray(bit_map), training=False))
    port = Q.SpatialAdaptiveQuantization(C, calibration_mode=mode, smooth_transitions=False)
    load_jax_variables(port, v)
    for i, x in enumerate(xs):
        if i == 2:  # the third step on a frozen quantizer changes nothing
            v["quant_stats"]["frozen"] = np.asarray(True)
            Q.freeze_calibration(port)
        ref, upd = jq.apply(v, jnp.asarray(x), jnp.asarray(bit_map), training=False,
                            update_stats=True, mutable=["quant_stats"])
        v["quant_stats"] = jax.tree_util.tree_map(np.asarray, upd["quant_stats"])
        out = port(torch.from_numpy(x), torch.from_numpy(bit_map), update_stats=True)
        mine = to_jax_variables(port)["quant_stats"]
        assert set(mine) == set(v["quant_stats"])
        for k in ("running_min", "running_max", "num_batches", "frozen"):
            np.testing.assert_array_equal(mine[k], v["quant_stats"][k], err_msg=f"{k} {i}")
        if mode == "entropy":
            np.testing.assert_array_equal(mine["histogram"], v["quant_stats"]["histogram"])
            assert mine["histogram"].sum() == pytest.approx(1.0, abs=1e-5)
        if mode in ("minmax", "entropy"):
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(port.num_batches) == 2 and bool(port.frozen)


def test_flax_entropy_checkpoint_round_trip(tmp_path):
    """A flax-written entropy-mode quantizer state (histogram included) loads
    into the port and is written back bitwise; the port's entropy-mode
    MCAQYOLO exports the histogram under quant_stats/quantizer_p*/."""
    rng = np.random.default_rng(10)
    x = rng.normal(0, 1, (2, 16, 16, C)).astype(np.float32)
    bit_map = rng.integers(2, 9, (2, 4, 4)).astype(np.float32)
    jq = JaxQuant(calibration_mode="entropy")
    v = jq.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(bit_map), training=False)
    _, upd = jq.apply(v, jnp.asarray(x), jnp.asarray(bit_map), training=False,
                      update_stats=True, mutable=["quant_stats"])
    v = {**v, "quant_stats": upd["quant_stats"]}
    path = tmp_path / "q.ckpt"
    path.write_bytes(serialization.msgpack_serialize(jax.tree_util.tree_map(np.asarray, v)))
    port = Q.SpatialAdaptiveQuantization(C, calibration_mode="entropy")
    load_jax_variables(port, load_checkpoint(path))
    assert float(port.histogram.sum()) == pytest.approx(1.0, abs=1e-6)
    back = serialization.msgpack_restore(write_msgpack(to_jax_variables(port)))
    flat_a = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, v))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for k, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[k]), a, err_msg=str(k))

    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    model = MCAQYOLO(num_classes=4, calibration_mode="entropy", device="cpu")
    stats = to_jax_variables(model)["quant_stats"]
    assert all(stats[f"quantizer_p{i}"]["histogram"].shape == (2048,) for i in (3, 4, 5))


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="Unknown calibration mode"):
        Q.SpatialAdaptiveQuantization(C, calibration_mode="kl")


@pytest.mark.parametrize("num_channels", [None, C])
def test_learned_rounding_bitwise(num_channels):
    rng = np.random.default_rng(11)
    x = (rng.normal(0, 3, (4, 5, C))).astype(np.float32)
    jm = JaxRounding(num_channels=num_channels)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["alpha"] = rng.normal(0, 1, v["params"]["alpha"].shape).astype(np.float32)
    port = Q.LearnedRoundingQuantization(num_channels)
    load_jax_variables(port, v)
    np.testing.assert_array_equal(to_jax_variables(port)["params"]["alpha"], v["params"]["alpha"])
    out = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(out, np.asarray(jm.apply(v, jnp.asarray(x))))
