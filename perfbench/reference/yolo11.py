"""
Plain float32 YOLO11 (backbone of C3k2 blocks, SPPF and C2PSA attention, PAN
neck of C3k2 blocks, Detect head with the depthwise class branch) and the
MCAQ model on its three taps: the reference of cell `l11-serve-bs256` and of
the repository's CPU tests of the port's YOLO11.

Written from Ultralytics' `ultralytics/cfg/models/11/yolo11.yaml` and the
blocks it names (`ultralytics/nn/modules/block.py`: C3k2, C3k, Bottleneck,
C2PSA, PSABlock, Attention; `head.py`: Detect with `legacy` off) in the
state-dict layout of `mcaq_yolo_tpu_torch/models/{layers,yolo}.py`, so that a
state dict made here loads into the measured program unchanged.  Nothing here
imports the program.  The MCAQ model puts `reference.mcaq`'s analyzer, bit
mapper and quantizers on yaml layers 4, 6 and 10 (C3, C4, C5) and keeps its
`forward_blocks` contract; decode and NMS are `reference.network.detect`.

Departures from Ultralytics' code: submodules carry the port's names
(`ConvBnSiLU_i` for `cv1`, `cv2`, ...; `cls{i}_conv0` for `cv3[i][0]`);
BatchNorm's eps 1e-3 and momentum 0.03 are what Ultralytics'
`initialize_weights` sets; C3k2's attention option (`attn`, later families)
is off in yolo11.yaml and absent here.  The equations are Ultralytics'.

Precision: every convolution is `reference.network.Conv`'s ('fp32', or 'fp8'
for the control, set by `reference.network.set_precision`), grouped ones
included.  The attention's two products follow the precision of their own
`qkv` convolution: float32 in the reference, and in the control their
operands rounded to float8 e4m3 with a per-tensor scale, one precision below
the configuration's bfloat16 network.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import mcaq as rm
from . import network as rn

VARIANTS = {  # depth, width, max channels (yolo11.yaml `scales`)
    "yolo11n": (0.50, 0.25, 1024),
    "yolo11s": (0.50, 0.50, 1024),
    "yolo11m": (0.50, 1.00, 512),
    "yolo11l": (1.00, 1.00, 512),
    "yolo11x": (1.00, 1.50, 512),
}


def _scaled(variant: str):
    d, w, mc = VARIANTS[variant]
    return d, (lambda b: rn.ch(b, w, mc)), variant[-1] in "mlx"


def variant_channels(variant: str) -> Tuple[int, int, int]:
    """(C3, C4, C5): the outputs of yaml layers 4, 6 and 10."""
    _, c, _ = _scaled(variant)
    return c(512), c(512), c(1024)


def head_channels(variant: str) -> Tuple[int, int, int]:
    """The neck's P3 / P4 / P5 (yaml layers 16, 19, 22)."""
    _, c, _ = _scaled(variant)
    return c(256), c(512), c(1024)


class Conv(rn.Conv):
    """`reference.network.Conv` with groups also in the float8 control."""

    def forward(self, x):
        if self.precision == "fp8":
            return F.conv2d(rn.fp8_round(x), rn.fp8_round(self.weight), self.bias, self.stride,
                            self.padding, self.dilation, self.groups)
        return super().forward(x)


class ConvBnSiLU(nn.Module):
    """Ultralytics' Conv (SiLU with `act`, else ConvBn); `g` groups."""

    def __init__(self, c_in, c_out, k=1, s=1, act=True, g=1):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_out, k, s, k // 2, groups=g, bias=False)
        self.BatchNorm_0 = rn.BatchNorm2d(c_out, eps=rn.BN_EPS, momentum=rn.BN_MOMENTUM)
        self.act = act

    def forward(self, x, training=False):
        x = self.BatchNorm_0(self.Conv_0(x), training)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """3x3 to int(c_out e), 3x3 to c_out, residual when c_in == c_out."""

    def __init__(self, c_in, c_out, shortcut=True, e=0.5):
        super().__init__()
        h = int(c_out * e)
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, h, 3)
        self.ConvBnSiLU_1 = ConvBnSiLU(h, c_out, 3)
        self.add = shortcut and c_in == c_out

    def forward(self, x, training=False):
        y = self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, training), training)
        return x + y if self.add else y


class C3k(nn.Module):
    """C3 with n 3x3 Bottlenecks: cv3(cat(m(cv1(x)), cv2(x)))."""

    def __init__(self, c_in, c_out, n=2, shortcut=True, e=0.5):
        super().__init__()
        h = int(c_out * e)
        self.n = n
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, h, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(c_in, h, 1)
        for i in range(n):
            self.add_module(f"Bottleneck_{i}", Bottleneck(h, h, shortcut, 1.0))
        self.ConvBnSiLU_2 = ConvBnSiLU(2 * h, c_out, 1)

    def forward(self, x, training=False):
        y = self.ConvBnSiLU_0(x, training)
        for i in range(self.n):
            y = getattr(self, f"Bottleneck_{i}")(y, training)
        return self.ConvBnSiLU_2(torch.cat([y, self.ConvBnSiLU_1(x, training)], 1), training)


class C3k2(nn.Module):
    """C2f whose n inner blocks are C3k(h, h, 2) with `c3k`, else
    Bottleneck(h, h, e=0.5); h = int(c_out e); the residual is on."""

    def __init__(self, c_in, c_out, n=1, c3k=False, e=0.5, shortcut=True):
        super().__init__()
        self.h = int(c_out * e)
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, 2 * self.h, 1)
        kind = "C3k" if c3k else "Bottleneck"
        self.blocks = [f"{kind}_{i}" for i in range(n)]
        for name in self.blocks:
            self.add_module(name, C3k(self.h, self.h, 2, shortcut) if c3k
                            else Bottleneck(self.h, self.h, shortcut, 0.5))
        self.ConvBnSiLU_1 = ConvBnSiLU((2 + n) * self.h, c_out, 1)

    def forward(self, x, training=False):
        y = self.ConvBnSiLU_0(x, training)
        parts = [y[:, :self.h], y[:, self.h:]]
        for name in self.blocks:
            parts.append(getattr(self, name)(parts[-1], training))
        return self.ConvBnSiLU_1(torch.cat(parts, 1), training)


class Attention(nn.Module):
    """Ultralytics' Attention: qkv's channels per head [q (key_dim), k
    (key_dim), v (head_dim)]; x = v softmax(q^T k scale)^T + pe(v), then
    proj; head_dim = c / heads, key_dim = head_dim / 2, scale key_dim^-0.5."""

    def __init__(self, c, heads, attn_ratio=0.5):
        super().__init__()
        self.heads = heads
        self.head_dim = c // heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = ConvBnSiLU(c, c + 2 * self.key_dim * heads, 1, act=False)
        self.proj = ConvBnSiLU(c, c, 1, act=False)
        self.pe = ConvBnSiLU(c, c, 3, act=False, g=c)

    def forward(self, x, training=False):
        B, C, H, W = x.shape
        r = rn.fp8_round if self.qkv.Conv_0.precision == "fp8" else (lambda t: t)
        qkv = self.qkv(x, training).reshape(B, self.heads, 2 * self.key_dim + self.head_dim,
                                             H * W)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = ((r(q).transpose(-2, -1) @ r(k)) * self.scale).softmax(dim=-1)
        y = (r(v) @ r(attn).transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(y + self.pe(v.reshape(B, C, H, W), training), training)


class PSABlock(nn.Module):
    def __init__(self, c, heads, attn_ratio=0.5):
        super().__init__()
        self.Attention_0 = Attention(c, heads, attn_ratio)
        self.ConvBnSiLU_0 = ConvBnSiLU(c, 2 * c, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(2 * c, c, 1, act=False)

    def forward(self, x, training=False):
        x = x + self.Attention_0(x, training)
        return x + self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, training), training)


class C2PSA(nn.Module):
    """cv2(cat(a, m(b))), (a, b) the halves of cv1(x); n PSABlocks of
    c / 2 channels and c / 128 heads."""

    def __init__(self, c, n=1):
        super().__init__()
        self.h = c // 2
        self.n = n
        self.ConvBnSiLU_0 = ConvBnSiLU(c, 2 * self.h, 1)
        for i in range(n):
            self.add_module(f"PSABlock_{i}", PSABlock(self.h, self.h // 64))
        self.ConvBnSiLU_1 = ConvBnSiLU(2 * self.h, c, 1)

    def forward(self, x, training=False):
        y = self.ConvBnSiLU_0(x, training)
        a, b = y[:, :self.h], y[:, self.h:]
        for i in range(self.n):
            b = getattr(self, f"PSABlock_{i}")(b, training)
        return self.ConvBnSiLU_1(torch.cat([a, b], 1), training)


class SeparableConvBnSiLU(nn.Module):
    """Detect's class-branch stage: DWConv(c_in, c_in, 3), Conv(c_in, c_out, 1)."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, c_in, 3, g=c_in)
        self.ConvBnSiLU_1 = ConvBnSiLU(c_in, c_out, 1)

    def forward(self, x, training=False):
        return self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, training), training)


class Backbone(nn.Module):
    """yaml layers 0-10; returns layers 4, 6 and 10."""

    def __init__(self, variant):
        super().__init__()
        d, c, big = _scaled(variant)
        n = rn.depth(2, d)
        self.ConvBnSiLU_0 = ConvBnSiLU(3, c(64), 3, 2)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(64), c(128), 3, 2)
        self.C3k2_0 = C3k2(c(128), c(256), n, big, 0.25)
        self.ConvBnSiLU_2 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.C3k2_1 = C3k2(c(256), c(512), n, big, 0.25)
        self.ConvBnSiLU_3 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.C3k2_2 = C3k2(c(512), c(512), n, True)
        self.ConvBnSiLU_4 = ConvBnSiLU(c(512), c(1024), 3, 2)
        self.C3k2_3 = C3k2(c(1024), c(1024), n, True)
        self.SPPF_0 = rn.SPPF(c(1024), c(1024))
        self.C2PSA_0 = C2PSA(c(1024), n)

    def forward(self, x, training=False):
        t = training
        x = self.C3k2_0(self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, t), t), t)
        c3 = self.C3k2_1(self.ConvBnSiLU_2(x, t), t)
        c4 = self.C3k2_2(self.ConvBnSiLU_3(c3, t), t)
        c5 = self.C2PSA_0(self.SPPF_0(self.C3k2_3(self.ConvBnSiLU_4(c4, t), t), t), t)
        return c3, c4, c5


class Neck(nn.Module):
    """yaml layers 11-22."""

    def __init__(self, variant):
        super().__init__()
        d, c, big = _scaled(variant)
        n = rn.depth(2, d)
        c3, c4, c5 = variant_channels(variant)
        self.C3k2_0 = C3k2(c5 + c4, c(512), n, big)
        self.C3k2_1 = C3k2(c(512) + c3, c(256), n, big)
        self.ConvBnSiLU_0 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.C3k2_2 = C3k2(c(256) + c(512), c(512), n, big)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.C3k2_3 = C3k2(c(512) + c5, c(1024), n, True)

    def forward(self, c3, c4, c5, training=False):
        t = training
        p4 = self.C3k2_0(torch.cat([rn.up2(c5), c4], 1), t)
        p3 = self.C3k2_1(torch.cat([rn.up2(p4), c3], 1), t)
        n4 = self.C3k2_2(torch.cat([self.ConvBnSiLU_0(p3, t), p4], 1), t)
        n5 = self.C3k2_3(torch.cat([self.ConvBnSiLU_1(n4, t), c5], 1), t)
        return p3, n4, n5


class Head(nn.Module):
    """Detect: per scale the box branch (3x3, 3x3, 1x1 to 4 REG_MAX) and the
    class branch (two depthwise-separable stages, 1x1 to nc)."""

    def __init__(self, nc, variant):
        super().__init__()
        chans = head_channels(variant)
        c_box = max(16, chans[0] // 4, 4 * rn.REG_MAX)
        c_cls = max(chans[0], min(nc, 100))
        for i, cf in enumerate(chans):
            self.add_module(f"box{i}_conv0", ConvBnSiLU(cf, c_box, 3))
            self.add_module(f"box{i}_conv1", ConvBnSiLU(c_box, c_box, 3))
            self.add_module(f"box{i}_out", Conv(c_box, 4 * rn.REG_MAX, 1))
            self.add_module(f"cls{i}_conv0", SeparableConvBnSiLU(cf, c_cls))
            self.add_module(f"cls{i}_conv1", SeparableConvBnSiLU(c_cls, c_cls))
            self.add_module(f"cls{i}_out", Conv(c_cls, nc, 1))

    forward = rn.Head.forward


class YOLO11(nn.Module):
    """The plain YOLO11: (B, H, W, 3) uint8 -> raw maps."""

    def __init__(self, variant="yolo11n", nc=80):
        super().__init__()
        self.backbone = Backbone(variant)
        self.neck = Neck(variant)
        self.head = Head(nc, variant)

    features = rn.YOLOv8.features
    forward = rn.YOLOv8.forward


class MCAQYOLO(rm.MCAQYOLO):
    """YOLO11 with the MCAQ transform on C3 / C4 / C5 before the neck:
    `reference.mcaq.MCAQYOLO`'s transform, forward and forward_blocks."""

    def __init__(self, variant="yolo11n", nc=80, grid=8, downsample=1):
        nn.Module.__init__(self)
        self.backbone = Backbone(variant)
        self.neck = Neck(variant)
        self.head = Head(nc, variant)
        self.complexity_analyzer = rm.Analyzer(grid, downsample)
        self.bit_mapper = rm.BitMapper()
        for i, c in enumerate(variant_channels(variant)):
            self.add_module(f"quantizer_p{i + 3}", rm.Quantizer(c))


def network_flops(variant: str, nc: int, img: int) -> Tuple[int, int]:
    """(convolutions, attention products) of one image through the network:
    2 x MACs of every convolution (`reference.network.conv_flops`), and 2 x
    MACs of each attention's q^T k (N x N x key_dim a head) and of its
    v attn^T (N x N x head_dim a head), N = H * W, counted from the shapes."""
    products = [0]

    def hook(m, args, out):
        N = args[0].shape[2] * args[0].shape[3]
        products[0] += 2 * m.heads * N * N * (m.key_dim + m.head_dim)

    with torch.device("meta"):
        net = YOLO11(variant, nc)
        hs = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, Attention)]

        class Body(nn.Module):
            def __init__(self):
                super().__init__()
                self.n = net

            def forward(self, x):
                return self.n.head(self.n.neck(*self.n.backbone(x)))

        convs = rn.conv_flops(Body(), torch.empty((1, 3, img, img)))
    for h in hs:
        h.remove()
    return convs, products[0]
