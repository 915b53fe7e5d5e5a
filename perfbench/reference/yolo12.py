"""
Plain float32 YOLO12 (backbone of C3k2 blocks and R-ELAN A2C2f blocks of
area attention at P4 and P5, PAN neck of A2C2f blocks without attention and
a last C3k2, Detect head with the depthwise class branch) and the MCAQ
model on its three taps: the reference of cell `l12-serve-bs256` and of the
repository's CPU tests of the port's YOLO12.

Written from Ultralytics' `ultralytics/cfg/models/12/yolo12.yaml` and the
blocks it names (`ultralytics/nn/modules/block.py`: A2C2f, ABlock, AAttn,
C3k2, C3k; `head.py`: Detect with `legacy` off), with what
`ultralytics/nn/tasks.py:parse_model` adds at scales l and x (every A2C2f
with `residual=True, mlp_ratio=1.2`) and at m, l and x (`c3k=True` in every
C3k2), in the state-dict layout of `mcaq_yolo_tpu_torch/models/{layers,
yolo}.py`, so that a state dict made here loads into the measured program
unchanged.  Nothing here imports the program.  The MCAQ model puts
`reference.mcaq`'s analyzer, bit mapper and quantizers on yaml layers 4, 6
and 8 (C3, C4, C5) and keeps its `forward_blocks` contract; decode and NMS
are `reference.network.detect`.

The attention is written as Ultralytics writes it: per area and head, q^T k
scaled by head_dim^-0.5, a softmax over the keys, v attn^T, each an
explicit product.

Departures from Ultralytics' code: submodules carry the port's names
(`ConvBnSiLU_0` / `_1` for A2C2f's `cv1` / `cv2`, `ABlock_{2i}` and
`ABlock_{2i+1}` for the two ABlocks of `m[i]`, `C3k_i` for a C3k `m[i]`,
`AAttn_0` for `attn`, `ConvBnSiLU_0` / `_1` for `mlp[0]` / `mlp[1]`);
BatchNorm's eps 1e-3 and momentum 0.03 are what Ultralytics'
`initialize_weights` sets; an area that does not divide the tokens raises
ValueError where Ultralytics' reshape raises RuntimeError.  The equations
are Ultralytics'.

Weights (`init_`): the benchmark's rule (`perfbench/weights.py:init_`),
except where Ultralytics sets its own: each ABlock draws its convolutions'
weights from a normal of std 0.02 (`ABlock._init_weights`; its truncation
at +-2 is 100 std away), and each A2C2f's gamma starts at 0.01.  Under the
benchmark's lecun-normal rule the residual stream would grow about 1.9x in
std an ABlock, the eighth ABlock's attention logits would reach ~1e4, and
the softmax would amplify any rounding of q and k by as much: float32 on
NCHW against channels-last memory already moved yolo12l's C5 by 4%.

Precision: every convolution is `reference.network.Conv`'s ('fp32', or 'fp8'
for the control, set by `reference.network.set_precision`), grouped ones
included.  The attention's products follow the precision of their own `qkv`
convolution: float32 in the reference, and in the control q, k, v and the
attention weights rounded to float8 e4m3 with a per-tensor scale, as
`reference.yolo11`'s attention, one precision below the configuration's
bfloat16 network.  The layer-scale residual x + gamma * y is float32.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from . import mcaq as rm
from . import network as rn
from .yolo11 import C3k, C3k2, ConvBnSiLU, Head

VARIANTS = {  # depth, width, max channels (yolo12.yaml `scales`)
    "yolo12n": (0.50, 0.25, 1024),
    "yolo12s": (0.50, 0.50, 1024),
    "yolo12m": (0.50, 1.00, 512),
    "yolo12l": (1.00, 1.00, 512),
    "yolo12x": (1.00, 1.50, 512),
}
HEAD_DIM = 32  # A2C2f: c_ // 32 heads of 32 channels
GAMMA_INIT = 0.01
ABLOCK_STD = 0.02  # ABlock._init_weights: trunc_normal_(std=0.02)
INIT_STREAM = 12   # the seed's generator stream of the ABlock weights


def head(nc: int, variant: str) -> Head:
    """YOLO11's Detect head at the same scale: yolo11.yaml and yolo12.yaml
    have the same scales, and the head sees (c(256), c(512), c(1024))."""
    return Head(nc, "yolo11" + variant[-1])


def _scaled(variant: str):
    d, w, mc = VARIANTS[variant]
    return d, (lambda b: rn.ch(b, w, mc)), variant[-1] in "mlx", variant[-1] in "lx"


def variant_channels(variant: str) -> Tuple[int, int, int]:
    """(C3, C4, C5): the outputs of yaml layers 4, 6 and 8."""
    _, c, _, _ = _scaled(variant)
    return c(512), c(512), c(1024)


def head_channels(variant: str) -> Tuple[int, int, int]:
    """The neck's P3 / P4 / P5 (yaml layers 14, 17, 20)."""
    _, c, _, _ = _scaled(variant)
    return c(256), c(512), c(1024)


class AAttn(nn.Module):
    """Ultralytics' AAttn: qkv's channels per head [q, k, v] of head_dim
    each; the N = H * W tokens (row-major) in `area` runs of N / area, each
    attending within itself; x = v softmax(q^T k head_dim^-0.5)^T + pe(v),
    then proj; pe a depthwise 7x7 ConvBn."""

    def __init__(self, c, heads, area=1):
        super().__init__()
        self.heads, self.area = heads, area
        self.head_dim = c // heads
        self.qkv = ConvBnSiLU(c, 3 * c, 1, act=False)
        self.proj = ConvBnSiLU(c, c, 1, act=False)
        self.pe = ConvBnSiLU(c, c, 7, act=False, g=c)

    def forward(self, x, training=False):
        B, C, H, W = x.shape
        N, a, d = H * W, self.area, self.head_dim
        if N % a:
            raise ValueError(f"area {a} does not divide the {H} x {W} = {N} tokens")
        r = rn.fp8_round if self.qkv.Conv_0.precision == "fp8" else (lambda t: t)
        qkv = self.qkv(x, training).flatten(2).transpose(1, 2)           # (B, N, 3C)
        qkv = qkv.reshape(B * a, N // a, 3 * C)                          # the areas
        q, k, v = qkv.view(B * a, N // a, self.heads, 3 * d).permute(0, 2, 3, 1).split(
            [d, d, d], dim=2)                                            # (B a, heads, d, N / a)
        attn = ((r(q).transpose(-2, -1) @ r(k)) * d ** -0.5).softmax(dim=-1)
        y = r(v) @ r(attn).transpose(-2, -1)                             # (B a, heads, d, N / a)

        def to_map(t):
            return t.permute(0, 3, 1, 2).reshape(B, N, C).reshape(B, H, W, C).permute(0, 3, 1, 2)

        return self.proj(to_map(y) + self.pe(to_map(v), training), training)


class ABlock(nn.Module):
    """x + attn(x), then x + mlp(x): Conv(c, int(c r), 1), ConvBn back."""

    def __init__(self, c, heads, mlp_ratio=1.2, area=1):
        super().__init__()
        h = int(c * mlp_ratio)
        self.AAttn_0 = AAttn(c, heads, area)
        self.ConvBnSiLU_0 = ConvBnSiLU(c, h, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(h, c, 1, act=False)

    def forward(self, x, training=False):
        x = x + self.AAttn_0(x, training)
        return x + self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, training), training)


class A2C2f(nn.Module):
    """cv2(cat(y_0 .. y_n)), y_0 = cv1(x) (to c_ = c_out / 2), y_i =
    m_i(y_{i-1}); m_i two ABlocks (c_ / 32 heads) with `a2`, else C3k(c_,
    c_, 2); with `a2` and `residual`, x + gamma * out."""

    def __init__(self, c_in, c_out, n=1, a2=True, area=1, residual=False, mlp_ratio=2.0):
        super().__init__()
        h = c_out // 2
        if h % 32:
            raise ValueError(f"A2C2f's hidden width {h} is not a multiple of 32")
        self.n, self.a2 = n, a2
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, h, 1)
        for i in range(n):
            if a2:
                for j in (2 * i, 2 * i + 1):
                    self.add_module(f"ABlock_{j}", ABlock(h, h // HEAD_DIM, mlp_ratio, area))
            else:
                self.add_module(f"C3k_{i}", C3k(h, h, 2))
        self.ConvBnSiLU_1 = ConvBnSiLU((1 + n) * h, c_out, 1)
        self.gamma = nn.Parameter(torch.full((c_out,), GAMMA_INIT)) if a2 and residual else None

    def stage(self, i, y, training=False):
        if self.a2:
            y = getattr(self, f"ABlock_{2 * i}")(y, training)
            return getattr(self, f"ABlock_{2 * i + 1}")(y, training)
        return getattr(self, f"C3k_{i}")(y, training)

    def forward(self, x, training=False):
        ys = [self.ConvBnSiLU_0(x, training)]
        for i in range(self.n):
            ys.append(self.stage(i, ys[-1], training))
        y = self.ConvBnSiLU_1(torch.cat(ys, 1), training)
        if self.gamma is None:
            return y
        return x + self.gamma.view(1, -1, 1, 1) * y


class Backbone(nn.Module):
    """yaml layers 0-8; returns layers 4, 6 and 8."""

    def __init__(self, variant):
        super().__init__()
        d, c, big, lx = _scaled(variant)
        n, r = rn.depth(2, d), 1.2 if lx else 2.0
        self.ConvBnSiLU_0 = ConvBnSiLU(3, c(64), 3, 2)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(64), c(128), 3, 2)
        self.C3k2_0 = C3k2(c(128), c(256), n, big, 0.25)
        self.ConvBnSiLU_2 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.C3k2_1 = C3k2(c(256), c(512), n, big, 0.25)
        self.ConvBnSiLU_3 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.A2C2f_0 = A2C2f(c(512), c(512), rn.depth(4, d), True, 4, lx, r)
        self.ConvBnSiLU_4 = ConvBnSiLU(c(512), c(1024), 3, 2)
        self.A2C2f_1 = A2C2f(c(1024), c(1024), rn.depth(4, d), True, 1, lx, r)

    def forward(self, x, training=False):
        t = training
        x = self.C3k2_0(self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, t), t), t)
        c3 = self.C3k2_1(self.ConvBnSiLU_2(x, t), t)
        c4 = self.A2C2f_0(self.ConvBnSiLU_3(c3, t), t)
        c5 = self.A2C2f_1(self.ConvBnSiLU_4(c4, t), t)
        return c3, c4, c5


class Neck(nn.Module):
    """yaml layers 9-20."""

    def __init__(self, variant):
        super().__init__()
        d, c, _, _ = _scaled(variant)
        n = rn.depth(2, d)
        c3, c4, c5 = variant_channels(variant)
        self.A2C2f_0 = A2C2f(c5 + c4, c(512), n, False)
        self.A2C2f_1 = A2C2f(c(512) + c3, c(256), n, False)
        self.ConvBnSiLU_0 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.A2C2f_2 = A2C2f(c(256) + c(512), c(512), n, False)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.C3k2_0 = C3k2(c(512) + c5, c(1024), n, True)

    def forward(self, c3, c4, c5, training=False):
        t = training
        p4 = self.A2C2f_0(torch.cat([rn.up2(c5), c4], 1), t)
        p3 = self.A2C2f_1(torch.cat([rn.up2(p4), c3], 1), t)
        n4 = self.A2C2f_2(torch.cat([self.ConvBnSiLU_0(p3, t), p4], 1), t)
        n5 = self.C3k2_0(torch.cat([self.ConvBnSiLU_1(n4, t), c5], 1), t)
        return p3, n4, n5


class YOLO12(nn.Module):
    """The plain YOLO12: (B, H, W, 3) uint8 -> raw maps."""

    def __init__(self, variant="yolo12n", nc=80):
        super().__init__()
        self.backbone = Backbone(variant)
        self.neck = Neck(variant)
        self.head = head(nc, variant)

    features = rn.YOLOv8.features
    forward = rn.YOLOv8.forward


class MCAQYOLO(rm.MCAQYOLO):
    """YOLO12 with the MCAQ transform on C3 / C4 / C5 before the neck:
    `reference.mcaq.MCAQYOLO`'s transform, forward and forward_blocks."""

    def __init__(self, variant="yolo12n", nc=80, grid=8, downsample=1):
        nn.Module.__init__(self)
        self.backbone = Backbone(variant)
        self.neck = Neck(variant)
        self.head = head(nc, variant)
        self.complexity_analyzer = rm.Analyzer(grid, downsample)
        self.bit_mapper = rm.BitMapper()
        for i, c in enumerate(variant_channels(variant)):
            self.add_module(f"quantizer_p{i + 3}", rm.Quantizer(c))


def init_(model: nn.Module, seed: int, nc: int) -> nn.Module:
    """Every leaf from the seed by `perfbench/weights.py:init_`'s rules
    (which set a bare 1-d parameter to 0), then Ultralytics' own: every
    convolution weight inside an ABlock from a normal of std 0.02 (the
    seed's stream `INIT_STREAM`), each A2C2f's gamma 0.01."""
    from .. import weights
    from ..gen import generator

    weights.init_(model, seed, nc)
    g = generator(seed, next(model.parameters()).device, stream=INIT_STREAM)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ABlock):
                for conv in m.modules():
                    if isinstance(conv, nn.Conv2d):
                        conv.weight.normal_(0.0, ABLOCK_STD, generator=g)
            elif isinstance(m, A2C2f) and m.gamma is not None:
                m.gamma.fill_(GAMMA_INIT)
    return model


def network_flops(variant: str, nc: int, img: int) -> Tuple[int, int]:
    """(convolutions, attention products) of one image through the network:
    2 x MACs of every convolution (`reference.network.conv_flops`), and 2 x
    MACs of each area attention's q^T k and v attn^T, N / area x N / area x
    head_dim a head and area each, N = H * W, counted from the shapes."""
    return _count(variant, nc, img)[:2]


def attention_shapes(variant: str, img: int) -> List[Tuple[int, int, int, int]]:
    """(tokens N, channels C, heads, area) of each area attention of one
    forward at `img` px."""
    return _count(variant, 80, img)[2]


def _count(variant: str, nc: int, img: int):
    shapes = []

    def hook(m, args, out):
        shapes.append((args[0].shape[2] * args[0].shape[3], args[0].shape[1], m.heads, m.area))

    with torch.device("meta"):
        net = YOLO12(variant, nc)
        hs = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, AAttn)]

        class Body(nn.Module):
            def __init__(self):
                super().__init__()
                self.n = net

            def forward(self, x):
                return self.n.head(self.n.neck(*self.n.backbone(x)))

        convs = rn.conv_flops(Body(), torch.empty((1, 3, img, img)))
    for h in hs:
        h.remove()
    products = sum(2 * heads * area * (N // area) ** 2 * 2 * (C // heads)
                   for N, C, heads, area in shapes)
    return convs, products, shapes
