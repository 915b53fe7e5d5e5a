"""
YOLOv8 building blocks (port of `mcaq_yolo_tpu/models/layers.py:25-143`),
YOLO11's (Ultralytics `ultralytics/nn/modules/block.py`: C3k, C3k2,
Attention, PSABlock, C2PSA; the Detect head's depthwise class branch) and
RT-DETR's convolutional ones (`block.py`: HGStem, HGBlock, RepC3; `conv.py`:
LightConv, RepConv).

Tensors are NCHW in torch.channels_last memory, so the channel axis is the
contiguous one, as in the reference's NHWC.  Submodule names follow the
reference's flax scope names (ConvBnSiLU_0, Conv_0, BatchNorm_0, ...) so
that `weights_io` maps the flax variable tree one to one.

Every forward takes `training` (default False), as the reference's modules
do: BatchNorm then normalizes with the batch's statistics and updates its
running ones by flax's rule (`batch_norm.py`).  In eval on the card,
ConvBnSiLU's BatchNorm and SiLU are one in-place pass of the kernel
`csrc/bn_silu.cu` (`ops/bn_silu.py`), and a float32 ConvBnSiLU's
convolution is the kernel `csrc/conv_f32.py` (`ops/conv_f32.py`).

YOLO11's attention records the span 'psa.attention' and the counter
`psa_attention` (one an attention evaluated), C2PSA the span 'model.psa'
with the attribute `tokens` (`utils/profiling.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import initializers as init
from ..batch_norm import BatchNorm2d
from ..ops import bn_silu, conv_f32
from ..utils.profiling import count, span

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch convention; flax momentum 0.97


class ConvBnSiLU(nn.Module):
    """Conv2d (symmetric `padding`, default k//2, no bias, `groups`) +
    BatchNorm(eps 1e-3) + SiLU (`act` True; False: ConvBn; 'relu': ReLU).

    The convolution runs in its weight's dtype (bfloat16 on the deployed
    path) or in autocast's (bfloat16 training with float32 weights); a
    float32 one on the card with nothing to differentiate (the KD teacher,
    a float32 model in eval) runs the kernel `csrc/conv_f32.py`
    (`conv_f32.takes`), float32-accurate on the tensor cores.  BatchNorm
    keeps float32 statistics and affine parameters.  In eval,
    where the kernel takes the convolution's output (`bn_silu.takes`: on
    the card, nothing to differentiate), BatchNorm and SiLU are one pass of
    it over that output, in place; otherwise `F.batch_norm` then
    `F.silu`.  A ReLU ConvBn runs `F.batch_norm` then `F.relu`."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 1, stride: int = 1,
                 act=True, groups: int = 1, padding: Optional[int] = None):
        super().__init__()
        if act not in (True, False, "relu"):
            raise ValueError(f"act must be True (SiLU), False or 'relu', got {act!r}")
        self.Conv_0 = nn.Conv2d(c_in, c_out, kernel, stride,
                                kernel // 2 if padding is None else padding, bias=False,
                                groups=groups)
        self.BatchNorm_0 = BatchNorm2d(c_out, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    @torch.no_grad()
    def init_weights(self, g: torch.Generator):
        init.lecun_normal_(self.Conv_0.weight, g)
        self.BatchNorm_0.reset_parameters()

    def forward(self, x, training: bool = False):
        conv = self.Conv_0
        x = conv_f32.conv2d(x, conv) if conv_f32.takes(x, conv) else conv(x)
        if self.act is True and not training and bn_silu.takes(x, self.BatchNorm_0):
            return bn_silu.bn_silu_(x, self.BatchNorm_0)
        x = self.BatchNorm_0(x, training)
        if self.act == "relu":
            return F.relu(x)
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
        self.blocks = []
        for i in range(n):
            kind, block = self.block(shortcut)
            self.blocks.append(f"{kind}_{i}")
            self.add_module(self.blocks[-1], block)
        self.ConvBnSiLU_1 = ConvBnSiLU((2 + n) * self.hidden, c_out, 1)

    def block(self, shortcut: bool):
        """(name, module) of one inner block."""
        return "Bottleneck", Bottleneck(self.hidden, self.hidden, shortcut, 1.0)

    def forward(self, x, training: bool = False):
        y = self.ConvBnSiLU_0(x, training)
        parts = [y[:, :self.hidden], y[:, self.hidden:]]
        for name in self.blocks:
            parts.append(self._modules[name](parts[-1], training))
        return self.ConvBnSiLU_1(torch.cat(parts, dim=1), training)


class C3k(nn.Module):
    """CSP bottleneck with 3 convolutions and 3x3 bottlenecks: cv1 -> n
    Bottlenecks (expansion 1.0), concat with cv2 (beside them) -> cv3."""

    def __init__(self, c_in: int, c_out: int, n: int = 2, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(c_out * expansion)
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, hidden, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(c_in, hidden, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"Bottleneck_{i}", Bottleneck(hidden, hidden, shortcut, 1.0))
        self.ConvBnSiLU_2 = ConvBnSiLU(2 * hidden, c_out, 1)

    def forward(self, x, training: bool = False):
        y = self.ConvBnSiLU_0(x, training)
        for i in range(self.n):
            y = getattr(self, f"Bottleneck_{i}")(y, training)
        return self.ConvBnSiLU_2(torch.cat([y, self.ConvBnSiLU_1(x, training)], dim=1),
                                 training)


class C3k2(C2f):
    """YOLO11's C2f: the inner blocks are C3k (two 3x3 Bottlenecks) with
    `c3k`, else Bottlenecks of expansion 0.5; the residual is on."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, c3k: bool = False,
                 expansion: float = 0.5, shortcut: bool = True):
        self.c3k = c3k
        super().__init__(c_in, c_out, n, shortcut, expansion)

    def block(self, shortcut: bool):
        if self.c3k:
            return "C3k", C3k(self.hidden, self.hidden, 2, shortcut)
        return "Bottleneck", Bottleneck(self.hidden, self.hidden, shortcut, 0.5)


class Attention(nn.Module):
    """Multi-head self-attention over all H * W positions.  `qkv` (1x1
    ConvBn) holds per head [q (key_dim), k (key_dim), v (head_dim)]
    channels; head_dim = c / heads, key_dim = head_dim * attn_ratio.
    out = proj(v softmax(q^T k key_dim^-0.5)^T + pe(v)), `pe` a depthwise
    3x3 ConvBn, `proj` a 1x1 ConvBn.  The products run in the input's dtype
    (`F.scaled_dot_product_attention`)."""

    def __init__(self, c: int, heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.heads = heads
        self.head_dim = c // heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = ConvBnSiLU(c, c + 2 * self.key_dim * heads, 1, act=False)
        self.proj = ConvBnSiLU(c, c, 1, act=False)
        self.pe = ConvBnSiLU(c, c, 3, act=False, groups=c)

    def forward(self, x, training: bool = False):
        B, C, H, W = x.shape
        with span("psa.attention"):
            count("psa_attention")
            # (B, H*W, heads, 2 key_dim + head_dim): a view of channels-last memory
            qkv = self.qkv(x, training).permute(0, 2, 3, 1).reshape(
                B, H * W, self.heads, 2 * self.key_dim + self.head_dim)
            q, k, v = qkv.transpose(1, 2).split(
                [self.key_dim, self.key_dim, self.head_dim], dim=-1)
            o = F.scaled_dot_product_attention(q, k, v, scale=self.scale)

            def to_map(t):  # (B, heads, H*W, d) -> NCHW in channels-last memory
                return t.transpose(1, 2).reshape(B, H, W, C).permute(0, 3, 1, 2)

            return self.proj(to_map(o) + self.pe(to_map(v), training), training)


class PSABlock(nn.Module):
    """x + attention(x), then x + ffn(x): a 1x1 ConvBnSiLU to 2c and a 1x1
    ConvBn back."""

    def __init__(self, c: int, heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.Attention_0 = Attention(c, heads, attn_ratio)
        self.ConvBnSiLU_0 = ConvBnSiLU(c, 2 * c, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(2 * c, c, 1, act=False)

    def forward(self, x, training: bool = False):
        x = x + self.Attention_0(x, training)
        return x + self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, training), training)


class C2PSA(nn.Module):
    """cv1 -> split [:h], [h:] -> n PSABlocks (heads h // 64) on the second
    half -> concat -> cv2; h = c / 2.  One span 'model.psa' (attribute
    `tokens`: H * W)."""

    def __init__(self, c: int, n: int = 1):
        super().__init__()
        self.hidden = c // 2
        self.ConvBnSiLU_0 = ConvBnSiLU(c, 2 * self.hidden, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"PSABlock_{i}", PSABlock(self.hidden, self.hidden // 64))
        self.ConvBnSiLU_1 = ConvBnSiLU(2 * self.hidden, c, 1)

    def forward(self, x, training: bool = False):
        with span("model.psa", tokens=x.shape[2] * x.shape[3]):
            y = self.ConvBnSiLU_0(x, training)
            a, b = y[:, :self.hidden], y[:, self.hidden:]
            for i in range(self.n):
                b = getattr(self, f"PSABlock_{i}")(b, training)
            return self.ConvBnSiLU_1(torch.cat([a, b], dim=1), training)


class SeparableConvBnSiLU(nn.Module):
    """A depthwise 3x3 ConvBnSiLU, then a 1x1 ConvBnSiLU to `c_out`: one
    stage of YOLO11's Detect class branch."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, c_in, 3, groups=c_in)
        self.ConvBnSiLU_1 = ConvBnSiLU(c_in, c_out, 1)

    def forward(self, x, training: bool = False):
        return self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, training), training)


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


def dwconv(c_in: int, c_out: int, kernel: int, stride: int = 1, act=True) -> ConvBnSiLU:
    """Ultralytics' DWConv: a ConvBnSiLU of gcd(c_in, c_out) groups."""
    return ConvBnSiLU(c_in, c_out, kernel, stride, act, groups=math.gcd(c_in, c_out))


class HGStem(nn.Module):
    """HGNetv2's stem (stride 4), every ConvBn with ReLU: stem1 (3x3 s2);
    padded right and bottom by 1, stem2a (2x2, no padding), padded again,
    stem2b (2x2) beside a 2x2 stride-1 max pool of the padded stem1;
    concatenated, stem3 (3x3 s2) and stem4 (1x1)."""

    def __init__(self, c_in: int, c_mid: int, c_out: int):
        super().__init__()
        self.stem1 = ConvBnSiLU(c_in, c_mid, 3, 2, "relu")
        self.stem2a = ConvBnSiLU(c_mid, c_mid // 2, 2, 1, "relu", padding=0)
        self.stem2b = ConvBnSiLU(c_mid // 2, c_mid, 2, 1, "relu", padding=0)
        self.stem3 = ConvBnSiLU(2 * c_mid, c_mid, 3, 2, "relu")
        self.stem4 = ConvBnSiLU(c_mid, c_out, 1, 1, "relu")

    def forward(self, x, training: bool = False):
        t = training
        x = F.pad(self.stem1(x, t), [0, 1, 0, 1])
        x2 = self.stem2b(F.pad(self.stem2a(x, t), [0, 1, 0, 1]), t)
        x1 = F.max_pool2d(x, 2, 1, 0, ceil_mode=True)
        return self.stem4(self.stem3(torch.cat([x1, x2], dim=1), t), t)


class LightConv(nn.Module):
    """A 1x1 ConvBn, then a depthwise k x k ConvBn with ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel: int):
        super().__init__()
        self.conv1 = ConvBnSiLU(c_in, c_out, 1, 1, False)
        self.conv2 = dwconv(c_out, c_out, kernel, 1, "relu")

    def forward(self, x, training: bool = False):
        return self.conv2(self.conv1(x, training), training)


class HGBlock(nn.Module):
    """HGNetv2's block: y0 = x, y_i = m_i(y_{i-1}) for n layers (a k x k
    ConvBn with ReLU, or `light` a LightConv) to `c_mid` channels; out =
    ec(sc(cat(y_0..y_n))), sc a 1x1 to c_out / 2 and ec a 1x1 to c_out,
    both with ReLU; plus x with `shortcut` when c_in == c_out."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, kernel: int = 3, n: int = 6,
                 light: bool = False, shortcut: bool = False):
        super().__init__()
        self.n = n
        for i in range(n):
            c = c_in if i == 0 else c_mid
            self.add_module(f"m_{i}", LightConv(c, c_mid, kernel) if light
                            else ConvBnSiLU(c, c_mid, kernel, 1, "relu"))
        self.sc = ConvBnSiLU(c_in + n * c_mid, c_out // 2, 1, 1, "relu")
        self.ec = ConvBnSiLU(c_out // 2, c_out, 1, 1, "relu")
        self.add = shortcut and c_in == c_out

    def forward(self, x, training: bool = False):
        ys = [x]
        for i in range(self.n):
            ys.append(getattr(self, f"m_{i}")(ys[-1], training))
        y = self.ec(self.sc(torch.cat(ys, dim=1), training), training)
        return y + x if self.add else y


class RepConv(nn.Module):
    """SiLU(ConvBn 3x3 (x) + ConvBn 1x1 (x)): RT-DETR's RepConv without its
    identity BatchNorm, in its training form (two branches, not fused)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv1 = ConvBnSiLU(c_in, c_out, 3, 1, False)
        self.conv2 = ConvBnSiLU(c_in, c_out, 1, 1, False)

    def forward(self, x, training: bool = False):
        return F.silu(self.conv1(x, training) + self.conv2(x, training))


class RepC3(nn.Module):
    """m(cv1(x)) + cv2(x): cv1 and cv2 1x1 ConvBnSiLU to c_out, m n RepConvs
    (expansion 1, so Ultralytics' cv3 is the identity)."""

    def __init__(self, c_in: int, c_out: int, n: int = 3):
        super().__init__()
        self.n = n
        self.cv1 = ConvBnSiLU(c_in, c_out, 1)
        self.cv2 = ConvBnSiLU(c_in, c_out, 1)
        for i in range(n):
            self.add_module(f"m_{i}", RepConv(c_out, c_out))

    def forward(self, x, training: bool = False):
        y = self.cv1(x, training)
        for i in range(self.n):
            y = getattr(self, f"m_{i}")(y, training)
        return y + self.cv2(x, training)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample (a pure repeat)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
