"""
Spatial adaptive quantization (port of
`mcaq_yolo_tpu/core/quantization.py:45-82, 116-327, 383-478`).

    X_q(p) = m(p) * Q_{bT(p)}(X(p))          (paper Eq.19)

Per-channel min/max calibration with EMA state (momentum 0.99; the first
batch is taken as-is; a frozen quantizer keeps its statistics).  The range
is the running statistics when they exist and the quantizer is training or
frozen, else the batch's own min/max.  That rule is evaluated on the
device with `torch.where`, as the reference evaluates it with `jnp.where`,
so a forward never waits on the host.

Eval (integer bit map): the fused quantize -> dequantize (x m) runs through
`ops.spatial_quant.spatial_quantize`: the hand-written CUDA kernel for
CUDA tensors (`backend='auto'`), or its plain PyTorch version
(`backend='torch'`, or any CPU tensor).  No gradient.

Training (continuous bit map): fractional-bit composition of the seven
per-bit fake quantizations with the straight-through estimator, so the
detection and distillation gradients reach the bit mapper through the
quantizer and the soft mask is trained.  The reference runs this in XLA,
not in its Pallas kernel; here it is PyTorch ops with autograd.

Not ported here: the 'percentile' / 'entropy' / 'mse' calibration modes
(NotImplementedError; ROADMAP queue A).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import initializers as init
from ..ops import spatial_quant
from . import image_ops as iops
from .ste import clip, ste

MIN_BITS, MAX_BITS = 2, 8
EMA_MOMENTUM = 0.99  # running min/max


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
    """The seven fake-quantized versions of x, {b: Q_b(x)} for b = 2..8."""
    return {b: quantize_tensor(x, x_min, x_max, b, training)
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
        m = iops.gaussian_blur_edge(m, self.kernel_size, self.kernel_size / 3.0)
        return m[..., None]


class SpatialAdaptiveQuantization(nn.Module):
    """Tile-wise mixed-precision quantizer.

    Buffers mirror the reference's 'quant_stats' collection:
    running_min / running_max (C,), num_batches () int32, frozen () bool."""

    def __init__(self, num_channels: int, calibration_mode: str = "minmax",
                 smooth_transitions: bool = True, backend: str = "auto"):
        super().__init__()
        if calibration_mode != "minmax":
            raise NotImplementedError(
                f"calibration_mode {calibration_mode!r} is not ported yet "
                "(only 'minmax')")
        if backend not in ("auto", "torch"):
            raise ValueError(f"unknown quantizer backend {backend!r}")
        self.backend = backend
        self.register_buffer("running_min", torch.zeros(num_channels))
        self.register_buffer("running_max", torch.zeros(num_channels))
        self.register_buffer("num_batches", torch.zeros((), dtype=torch.int32))
        self.register_buffer("frozen", torch.zeros((), dtype=torch.bool))
        self.soft_mask = LearnedSoftMask() if smooth_transitions else None

    def _batch_minmax(self, x: torch.Tensor):
        lo, hi = torch.aminmax(x.reshape(-1, x.shape[-1]), dim=0)
        return lo.to(torch.float32), hi.to(torch.float32)

    @torch.no_grad()
    def ema_update(self, x: torch.Tensor) -> None:
        """One EMA step of the running min/max from x's batch min/max: the
        first batch is taken as-is, a frozen quantizer keeps its state."""
        bx_min, bx_max = self._batch_minmax(x)
        first = self.num_batches == 0
        keep = self.frozen
        m = EMA_MOMENTUM
        new_min = torch.where(first, bx_min, m * self.running_min + (1 - m) * bx_min)
        new_max = torch.where(first, bx_max, m * self.running_max + (1 - m) * bx_max)
        self.running_min.copy_(torch.where(keep, self.running_min, new_min))
        self.running_max.copy_(torch.where(keep, self.running_max, new_max))
        self.num_batches.copy_(torch.where(keep, self.num_batches, self.num_batches + 1))

    @torch.no_grad()
    def calibration_range(self, x: torch.Tensor, training: bool = False):
        """Per-channel (x_min, x_max), each (C,) float32: the running stats
        when they exist and the quantizer is training or frozen, else the
        batch's own min/max."""
        bx_min, bx_max = self._batch_minmax(x)
        use_running = self.num_batches > 0
        if not training:
            use_running = use_running & self.frozen
        x_min = torch.where(use_running, self.running_min, bx_min)
        x_max = torch.where(use_running, self.running_max, bx_max)
        return x_min.contiguous(), x_max.contiguous()

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
    calibration images, then frozen), in place."""
    for m in model.modules():
        if isinstance(m, SpatialAdaptiveQuantization):
            m.frozen.fill_(True)
    return model
