"""
Spatial adaptive quantization (port of
`mcaq_yolo_tpu/core/quantization.py:45-478`).

    X_q(p) = m(p) * Q_{bT(p)}(X(p))          (paper Eq.19)

Per-channel min/max EMA state (momentum 0.99; the first batch is taken
as-is; a frozen quantizer keeps its statistics) and four calibration modes
for the range:
  * 'minmax': the running statistics when they exist and the quantizer is
    training or frozen, else the batch's own per-channel min/max;
  * 'percentile': the batch's per-channel 0.01 / 99.99 percentiles
    (`jnp.quantile`'s linear interpolation);
  * 'entropy': the 99.9% central mass of a 2048-bin EMA histogram of the
    batches, mapped symmetrically onto the batch's |x| max;
  * 'mse': per bit width, the alpha in linspace(0.8, 1, 100) whose range
    alpha * (min, max) minimises the reconstruction MSE: (7, 1) ranges,
    one row per bit width, which the kernel takes as per-bit rows.
Every rule is evaluated on the device (`torch.where`, `kthvalue`,
`searchsorted`, `argmin`), as the reference evaluates it in XLA, so a
forward never waits on the host.

Eval (integer bit map): the fused quantize -> dequantize (x m) runs through
`ops.spatial_quant.spatial_quantize`: the hand-written CUDA kernel for
CUDA tensors (`backend='auto'`), or its plain PyTorch version
(`backend='torch'`, or any CPU tensor).  No gradient.

Training (continuous bit map): fractional-bit composition of the seven
per-bit fake quantizations with the straight-through estimator, so the
detection and distillation gradients reach the bit mapper through the
quantizer and the soft mask is trained.  The reference runs this in XLA,
not in its Pallas kernel; here it is PyTorch ops with autograd.

`LearnedRoundingQuantization` (AdaRound-style, inference only) is kept for
parity with the reference, which never trains it either.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import initializers as init
from ..ops import spatial_quant
from . import image_ops as iops
from .ste import clip, ste

MIN_BITS, MAX_BITS = 2, 8
EMA_MOMENTUM = 0.99  # running min/max and the entropy histogram
HISTOGRAM_BINS = 2048
CALIBRATION_MODES = ("minmax", "percentile", "entropy", "mse")
MSE_CANDIDATES = 100


def qrange(bits: int):
    """Signed range of a bit width: (-2^(b-1), 2^(b-1) - 1)."""
    half = 2.0 ** (bits - 1)
    return -half, half - 1.0


def compute_scale_zeropoint(x_min, x_max, bits: int):
    """scale = (max - min) / (qmax - qmin), zp = qmin - min / scale clamped
    to [qmin, qmax]; per channel."""
    qmin, qmax = qrange(bits)
    x_range = torch.clamp(x_max - x_min, min=1e-8)
    scale = x_range / (qmax - qmin)
    zero_point = torch.clamp(qmin - x_min / scale, qmin, qmax)
    return scale, zero_point


def fake_quantize(x, scale, zero_point, qmin: float, qmax: float, training: bool = True):
    """Quantize / dequantize.  With `training` the straight-through
    estimator gives the identity gradient w.r.t. x (even at saturation);
    scale and zero point carry no gradient."""
    scale = scale.detach()
    zero_point = zero_point.detach()
    q = torch.clamp(torch.round(x / scale + zero_point), qmin, qmax)
    deq = (q - zero_point) * scale
    return ste(x, deq) if training else deq


def quantize_tensor(x, x_min, x_max, bits: int, training: bool = True):
    """Single-bit-width fake quantization with min/max-derived parameters."""
    scale, zp = compute_scale_zeropoint(x_min, x_max, bits)
    qmin, qmax = qrange(bits)
    return fake_quantize(x, scale, zp, qmin, qmax, training)


def per_bit_quantize(x, x_min, x_max, training: bool = True):
    """The seven fake-quantized versions of x, {b: Q_b(x)} for b = 2..8.
    x_min / x_max (C,) shared by every bit width, or (7, C') per-bit rows
    (mse calibration): row b - 2 quantizes at b bits."""
    per_bit = x_min.dim() == 2
    return {b: quantize_tensor(x, x_min[b - MIN_BITS] if per_bit else x_min,
                               x_max[b - MIN_BITS] if per_bit else x_max, b, training)
            for b in range(MIN_BITS, MAX_BITS + 1)}


def compose_fractional(x, bit_map, x_min, x_max):
    """Training compose, x_q = (1 - frac) Q_floor(x) + frac Q_ceil(x), per
    tile: d x_q / d b = Q_ceil(x) - Q_floor(x), so the gradient reaches the
    bit map.  x (B, H, W, C) float32; bit_map (B, Ht, Wt) continuous."""
    H, W = x.shape[1:3]
    b_floor = torch.floor(bit_map.detach())
    frac = bit_map - b_floor  # carries the gradient to the mapper
    frac_up = iops.upsample_nearest(frac, (H, W))[..., None]
    qs = per_bit_quantize(x, x_min, x_max, training=True)
    x_q = torch.zeros_like(x)
    for b in range(MIN_BITS, MAX_BITS + 1):
        sel = (b_floor == b).to(x.dtype)
        sel_up = iops.upsample_nearest(sel, (H, W))[..., None]
        q_lo = qs[b]
        q_hi = qs[min(b + 1, MAX_BITS)]  # frac == 0 exactly at b == bmax
        x_q = x_q + sel_up * ((1.0 - frac_up) * q_lo + frac_up * q_hi)
    return x_q


class LearnedRoundingQuantization(nn.Module):
    """AdaRound-style rounding: floor(x) + sigmoid(alpha) (ceil(x) - floor(x)),
    alpha per channel (last axis) or one global value.

    Inference only, as in the reference (`quantization.py:90-108`), which
    applies it only outside training, so alpha never receives a gradient and
    stays at sigmoid(0) = 0.5 (midpoint interpolation).  The parameter is
    named `alpha` so that flax checkpoints map onto it."""

    def __init__(self, num_channels: Optional[int] = None):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(num_channels if num_channels else 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.sigmoid(self.alpha)
        x_floor = torch.floor(x)
        return x_floor + a * (torch.ceil(x) - x_floor)


def batch_histogram(x: torch.Tensor, bins: int = HISTOGRAM_BINS) -> torch.Tensor:
    """Normalized histogram of float32 x over its own [min, max] (reference
    `_batch_histogram`, `quantization.py:305-315`): bin int32(t * bins) of
    t = (x - min) / max(max - min, 1e-12) clipped to [0, 1].  Counted
    exactly in int64 (the reference adds 1.0 per element in float32, the
    same up to 2^24 per bin)."""
    flat = x.reshape(-1)
    lo, hi = torch.aminmax(flat)
    t = torch.clamp((flat - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    idx = torch.clamp((t * bins).to(torch.int32), 0, bins - 1)
    h = torch.bincount(idx, minlength=bins).to(torch.float32)
    return h / torch.clamp(h.sum(), min=1.0)


def channel_quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """Per-column quantile of float32 (N, C) with `jnp.quantile`'s 'linear'
    method, in its arithmetic: the position q (n - 1) in float32, the order
    statistics at its floor and ceil (`kthvalue`: no size limit, unlike
    `torch.quantile`'s 2^24 elements), weights 1 - frac and frac; a column
    holding a NaN gives NaN.  The position depends only on the shape, so it
    is computed on the host; the values stay on the device."""
    n = np.float32(flat.shape[0])
    pos = np.float32(q) * (n - np.float32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    w_low = np.float32(1.0) - w_high
    low = int(np.clip(low, 0, n - 1))
    high = int(np.clip(high, 0, n - 1))
    v_low = torch.kthvalue(flat, low + 1, dim=0).values
    v_high = v_low if high == low else torch.kthvalue(flat, high + 1, dim=0).values
    out = v_low * float(w_low) + v_high * float(w_high)
    return torch.where(torch.isnan(flat).any(dim=0), torch.full_like(out, float("nan")), out)


def mse_alphas(device=None) -> torch.Tensor:
    """The reference's candidate range multipliers, linspace(0.8, 1.0, 100)
    in float32 (`jnp.linspace`'s formula start (1 - s) + stop s with s = i /
    99; XLA evaluates it with a reciprocal, so single entries may differ by
    one ulp)."""
    s = torch.arange(MSE_CANDIDATES - 1, dtype=torch.float32) / (MSE_CANDIDATES - 1)
    a = 0.8 * (1.0 - s) + 1.0 * s
    return torch.cat([a, torch.ones(1)]).to(device)


def calibrate_mse(x: torch.Tensor, chunk_elements: int = 1 << 25):
    """MSE-optimal per-bit ranges (reference `_calibrate_mse`,
    `quantization.py:360-381`): for each bit width b = 2..8 the alpha whose
    range alpha * (min x, max x) minimises mean((x - Q_b(x))^2), first
    minimum on ties.  Returns (x_min, x_max), each (7, 1) float32.

    The grid is 7 x 100 full fake quantizations of x; it is walked bit by
    bit in chunks of alphas of at most `chunk_elements` quantized elements,
    so memory stays near x's size times the chunk, never the whole grid."""
    flat = x.reshape(1, -1).to(torch.float32)
    x_min, x_max = torch.aminmax(flat)
    alphas = mse_alphas(x.device)
    k = max(1, min(MSE_CANDIDATES, chunk_elements // max(flat.shape[1], 1)))
    best = []
    for b in range(MIN_BITS, MAX_BITS + 1):
        errors = []
        for i in range(0, MSE_CANDIDATES, k):
            a = alphas[i:i + k, None]
            xq = quantize_tensor(flat, x_min * a, x_max * a, b, training=False)
            errors.append((flat - xq).square().mean(dim=1))
        best.append(alphas[torch.argmin(torch.cat(errors))])
    best = torch.stack(best)[:, None]
    return x_min * best, x_max * best


class LearnedSoftMask(nn.Module):
    """m(p) in [0, 1]: per-tile [bits_norm, mean |x|] -> Conv3x3(2->8) ReLU
    -> Conv1x1(8->2) -> softmax channel 0 -> nearest upsample -> 5x5
    Gaussian blur with replicate padding.  The activation feature carries
    no gradient; bits_norm carries it to the bit mapper."""

    def __init__(self, hidden: int = 8, kernel_size: int = 5):
        super().__init__()
        self.kernel_size = kernel_size
        self.Conv_0 = nn.Conv2d(2, hidden, 3, padding=1)
        self.Conv_1 = nn.Conv2d(hidden, 2, 1)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator):
        init.lecun_normal_(self.Conv_0.weight, g)
        self.Conv_0.bias.zero_()
        init.normal_(self.Conv_1.weight, 1e-3, g)
        self.Conv_1.bias.copy_(torch.tensor([4.0, 0.0]))

    def forward(self, bit_map: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """bit_map (B, Ht, Wt); x (B, H, W, C) -> m (B, H, W, 1) float32."""
        B, H, W, C = x.shape
        Ht, Wt = bit_map.shape[-2:]
        act = torch.abs(x.detach()).mean(dim=-1, dtype=torch.float32)  # (B, H, W)
        act = iops.avg_pool(act, H // Ht)                          # (B, Ht, Wt)
        act = act / (act.amax(dim=(1, 2), keepdim=True) + 1e-8)
        bits_norm = clip((bit_map.to(torch.float32) - 2.0) / 6.0, 0.0, 1.0)
        feats = torch.stack([bits_norm, act], dim=1)               # (B, 2, Ht, Wt)
        logits = self.Conv_1(F.relu(self.Conv_0(feats)))
        m = torch.softmax(logits, dim=1)[:, 0]                     # (B, Ht, Wt)
        m = iops.upsample_nearest(m, (H, W))
        m = iops.gaussian_blur(m, self.kernel_size, self.kernel_size / 3.0, mode="edge")
        return m[..., None]


class SpatialAdaptiveQuantization(nn.Module):
    """Tile-wise mixed-precision quantizer.

    Buffers mirror the reference's 'quant_stats' collection:
    running_min / running_max (C,), num_batches () int32, frozen () bool,
    and in 'entropy' mode histogram (2048,) float32."""

    def __init__(self, num_channels: int, calibration_mode: str = "minmax",
                 smooth_transitions: bool = True, backend: str = "auto"):
        super().__init__()
        if calibration_mode not in CALIBRATION_MODES:
            raise ValueError(f"Unknown calibration mode: {calibration_mode}")
        if backend not in ("auto", "torch"):
            raise ValueError(f"unknown quantizer backend {backend!r}")
        self.calibration_mode = calibration_mode
        self.backend = backend
        self.register_buffer("running_min", torch.zeros(num_channels))
        self.register_buffer("running_max", torch.zeros(num_channels))
        self.register_buffer("num_batches", torch.zeros((), dtype=torch.int32))
        self.register_buffer("frozen", torch.zeros((), dtype=torch.bool))
        if calibration_mode == "entropy":
            self.register_buffer("histogram", torch.zeros(HISTOGRAM_BINS))
        self.soft_mask = LearnedSoftMask() if smooth_transitions else None

    def _batch_minmax(self, x: torch.Tensor):
        lo, hi = torch.aminmax(x.reshape(-1, x.shape[-1]), dim=0)
        return lo.to(torch.float32), hi.to(torch.float32)

    @torch.no_grad()
    def ema_update(self, x: torch.Tensor) -> None:
        """One EMA step of the running min/max from x's batch min/max (and,
        in 'entropy' mode, of the histogram): the first batch is taken
        as-is, a frozen quantizer keeps its state."""
        bx_min, bx_max = self._batch_minmax(x)
        first = self.num_batches == 0
        keep = self.frozen
        m = EMA_MOMENTUM
        new_min = torch.where(first, bx_min, m * self.running_min + (1 - m) * bx_min)
        new_max = torch.where(first, bx_max, m * self.running_max + (1 - m) * bx_max)
        self.running_min.copy_(torch.where(keep, self.running_min, new_min))
        self.running_max.copy_(torch.where(keep, self.running_max, new_max))
        self.num_batches.copy_(torch.where(keep, self.num_batches, self.num_batches + 1))
        if self.calibration_mode == "entropy":
            h = batch_histogram(x.to(torch.float32))
            # the reference tests the count after its increment
            new_hist = torch.where(self.num_batches <= 1, h,
                                   m * self.histogram + (1 - m) * h)
            self.histogram.copy_(torch.where(keep, self.histogram, new_hist))

    @torch.no_grad()
    def calibration_range(self, x: torch.Tensor, training: bool = False):
        """The range of the active mode: per-channel (x_min, x_max), each
        (C,) float32, or in 'mse' mode per-bit rows, each (7, 1)."""
        C = x.shape[-1]
        mode = self.calibration_mode
        if mode == "minmax":
            bx_min, bx_max = self._batch_minmax(x)
            use_running = self.num_batches > 0
            if not training:
                use_running = use_running & self.frozen
            x_min = torch.where(use_running, self.running_min, bx_min)
            x_max = torch.where(use_running, self.running_max, bx_max)
            return x_min.contiguous(), x_max.contiguous()
        xf = x.to(torch.float32)
        if mode == "percentile":
            flat = xf.reshape(-1, C)
            return channel_quantile(flat, 0.0001), channel_quantile(flat, 0.9999)
        if mode == "mse":
            return calibrate_mse(xf)
        # entropy: 99.9% central mass of the histogram, mapped symmetrically
        cum = torch.cumsum(self.histogram, dim=0)
        threshold = 0.999
        marks = torch.tensor([(1 - threshold) / 2, threshold + (1 - threshold) / 2],
                             dtype=torch.float32, device=x.device)
        idx = torch.searchsorted(cum, marks).to(torch.float32)  # side='left'
        abs_max = xf.abs().amax()
        x_min = -abs_max * idx[0] / HISTOGRAM_BINS
        x_max = abs_max * idx[1] / HISTOGRAM_BINS
        return x_min.expand(C).contiguous(), x_max.expand(C).contiguous()

    def forward(self, x: torch.Tensor, bit_map: torch.Tensor, training: bool = False,
                update_stats: Optional[bool] = None) -> torch.Tensor:
        """x (B, H, W, C) NHWC-contiguous; bit_map (B, Ht, Wt), continuous
        with `training`, else integer-valued.  `update_stats` (default:
        `training`) takes one EMA step before the range is read.  Returns
        x's dtype and layout."""
        if update_stats is None:
            update_stats = training
        if update_stats:
            self.ema_update(x)
        if training:
            xf = x.to(torch.float32)
            x_min, x_max = self.calibration_range(xf, training=True)
            x_q = compose_fractional(xf, bit_map, x_min, x_max)
            if self.soft_mask is not None:
                x_q = x_q * self.soft_mask(bit_map, xf)
            return x_q.to(x.dtype)
        with torch.no_grad():
            x_min, x_max = self.calibration_range(x)
            mask = None
            if self.soft_mask is not None:
                mask = self.soft_mask(bit_map, x)[..., 0]
            bit_map = bit_map.to(torch.float32).contiguous()
            if self.backend == "torch":
                return spatial_quant.spatial_quantize_torch(x, bit_map, x_min, x_max, mask)
            return spatial_quant.spatial_quantize(x, bit_map, x_min, x_max, mask)


@torch.no_grad()
def freeze_calibration(model: nn.Module) -> nn.Module:
    """Set every quantizer's `frozen` flag (paper Sec IV-D: EMA over
    calibration images, then frozen), in place.  A frozen quantizer keeps
    its running min/max, count and (entropy mode) histogram."""
    for m in model.modules():
        if isinstance(m, SpatialAdaptiveQuantization):
            m.frozen.fill_(True)
    return model
