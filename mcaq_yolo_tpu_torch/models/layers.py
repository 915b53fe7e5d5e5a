"""
YOLOv8 building blocks (port of `mcaq_yolo_tpu/models/layers.py:25-143`).

Tensors are NCHW in torch.channels_last memory, so the channel axis is the
contiguous one, as in the reference's NHWC.  Submodule names follow the
reference's flax scope names (ConvBnSiLU_0, Conv_0, BatchNorm_0, ...) so
that `weights_io` maps the flax variable tree one to one.

Every forward takes `training` (default False), as the reference's modules
do: BatchNorm then normalizes with the batch's statistics and updates its
running ones by flax's rule (`batch_norm.py`).  In eval on the card,
ConvBnSiLU's BatchNorm and SiLU are one in-place pass of the kernel
`csrc/bn_silu.cu` (`ops/bn_silu.py`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import initializers as init
from ..batch_norm import BatchNorm2d
from ..ops import bn_silu

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch convention; flax momentum 0.97


class ConvBnSiLU(nn.Module):
    """Conv2d (symmetric k//2 padding, no bias) + BatchNorm(eps 1e-3) + SiLU.

    The convolution runs in its weight's dtype (bfloat16 on the deployed
    path) or in autocast's (bfloat16 training with float32 weights);
    BatchNorm keeps float32 statistics and affine parameters.  In eval,
    where the kernel takes the convolution's output (`bn_silu.takes`: on
    the card, nothing to differentiate), BatchNorm and SiLU are one pass of
    it over that output, in place; otherwise `F.batch_norm` then
    `F.silu`."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 1, stride: int = 1,
                 act: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in, c_out, kernel, stride, kernel // 2, bias=False)
        self.BatchNorm_0 = BatchNorm2d(c_out, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    @torch.no_grad()
    def init_weights(self, g: torch.Generator):
        init.lecun_normal_(self.Conv_0.weight, g)
        self.BatchNorm_0.reset_parameters()

    def forward(self, x, training: bool = False):
        x = self.Conv_0(x)
        if self.act and not training and bn_silu.takes(x, self.BatchNorm_0):
            return bn_silu.bn_silu_(x, self.BatchNorm_0)
        x = self.BatchNorm_0(x, training)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """Two 3x3 ConvBnSiLU with a residual add when shapes allow."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(c_out * expansion)
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, hidden, 3)
        self.ConvBnSiLU_1 = ConvBnSiLU(hidden, c_out, 3)
        self.add = shortcut and c_in == c_out

    def forward(self, x, training: bool = False):
        y = self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, training), training)
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck, 'fast' variant: cv1 -> split [:h], [h:] -> n
    bottlenecks each appending a branch -> concat -> cv2."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, shortcut: bool = False,
                 expansion: float = 0.5):
        super().__init__()
        self.hidden = int(c_out * expansion)
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, 2 * self.hidden, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"Bottleneck_{i}",
                            Bottleneck(self.hidden, self.hidden, shortcut, 1.0))
        self.ConvBnSiLU_1 = ConvBnSiLU((2 + n) * self.hidden, c_out, 1)

    def forward(self, x, training: bool = False):
        y = self.ConvBnSiLU_0(x, training)
        parts = [y[:, :self.hidden], y[:, self.hidden:]]
        for i in range(self.n):
            parts.append(getattr(self, f"Bottleneck_{i}")(parts[-1], training))
        return self.ConvBnSiLU_1(torch.cat(parts, dim=1), training)


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained 5x5 max pools (stride 1,
    -inf padding)."""

    def __init__(self, c_in: int, c_out: int, pool_size: int = 5):
        super().__init__()
        hidden = c_in // 2
        self.pool_size = pool_size
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, hidden, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(4 * hidden, c_out, 1)

    def forward(self, x, training: bool = False):
        k = self.pool_size
        y = self.ConvBnSiLU_0(x, training)
        p1 = F.max_pool2d(y, k, 1, k // 2)
        p2 = F.max_pool2d(p1, k, 1, k // 2)
        p3 = F.max_pool2d(p2, k, 1, k // 2)
        return self.ConvBnSiLU_1(torch.cat([y, p1, p2, p3], dim=1), training)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample (a pure repeat)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
