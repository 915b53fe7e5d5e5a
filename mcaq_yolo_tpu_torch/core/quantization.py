"""
Spatial adaptive quantization, eval path (port of
`mcaq_yolo_tpu/core/quantization.py:45-61, 116-159, 167-296, 300-358,
421-460`).

    X_q(p) = m(p) * Q_{bT(p)}(X(p))          (paper Eq.19)

Per-channel min/max calibration: the batch's own range unless the
quantizer holds frozen running statistics (`num_batches > 0 and frozen`).
That rule is evaluated on the device with `torch.where`, as the reference
evaluates it with `jnp.where`, so a forward never waits on the host; the
batch min/max is therefore always computed.

The fused quantize -> dequantize (x m) runs through
`ops.spatial_quant.spatial_quantize`: the hand-written CUDA kernel for
CUDA tensors (`backend='auto'`), or its plain PyTorch version
(`backend='torch'`, or any CPU tensor).

Not ported here: the train branch (EMA update, fractional-bit compose) and
the 'percentile' / 'entropy' / 'mse' calibration modes; they raise
NotImplementedError (ROADMAP queue A).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import initializers as init
from ..ops import spatial_quant
from . import image_ops as iops


class LearnedSoftMask(nn.Module):
    """m(p) in [0, 1]: per-tile [bits_norm, mean |x|] -> Conv3x3(2->8) ReLU
    -> Conv1x1(8->2) -> softmax channel 0 -> nearest upsample -> 5x5
    Gaussian blur with replicate padding."""

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
        act = torch.abs(x).mean(dim=-1, dtype=torch.float32)       # (B, H, W)
        act = iops.avg_pool(act, H // Ht)                          # (B, Ht, Wt)
        act = act / (act.amax(dim=(1, 2), keepdim=True) + 1e-8)
        bits_norm = torch.clamp((bit_map.to(torch.float32) - 2.0) / 6.0, 0.0, 1.0)
        feats = torch.stack([bits_norm, act], dim=1)               # (B, 2, Ht, Wt)
        logits = self.Conv_1(F.relu(self.Conv_0(feats)))
        m = torch.softmax(logits, dim=1)[:, 0]                     # (B, Ht, Wt)
        m = iops.upsample_nearest(m, (H, W))
        m = iops.gaussian_blur_edge(m, self.kernel_size, self.kernel_size / 3.0)
        return m[..., None]


class SpatialAdaptiveQuantization(nn.Module):
    """Tile-wise mixed-precision quantizer, eval path.

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

    def calibration_range(self, x: torch.Tensor):
        """Per-channel (x_min, x_max), each (C,) float32: running stats when
        they exist and are frozen, else the batch's own min/max."""
        bx_min, bx_max = self._batch_minmax(x)
        use_running = (self.num_batches > 0) & self.frozen
        x_min = torch.where(use_running, self.running_min, bx_min)
        x_max = torch.where(use_running, self.running_max, bx_max)
        return x_min.contiguous(), x_max.contiguous()

    @torch.no_grad()
    def forward(self, x: torch.Tensor, bit_map: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        """x (B, H, W, C) NHWC-contiguous; bit_map (B, Ht, Wt) integer-valued.
        Returns x's dtype and layout."""
        if training:
            raise NotImplementedError("the quantizer's train branch is not ported yet")
        x_min, x_max = self.calibration_range(x)
        mask = None
        if self.soft_mask is not None:
            mask = self.soft_mask(bit_map, x)[..., 0]
        bit_map = bit_map.to(torch.float32).contiguous()
        if self.backend == "torch":
            return spatial_quant.spatial_quantize_torch(x, bit_map, x_min, x_max, mask)
        return spatial_quant.spatial_quantize(x, bit_map, x_min, x_max, mask)
