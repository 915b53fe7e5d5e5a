"""
Detection model families YOLOv8, YOLO11 and YOLO12 (scales n/s/m/l/x), the
family table that also names RT-DETR (`rtdetr-l`, built in
`models/rtdetr.py`), and the deployed decode + NMS (port of
`mcaq_yolo_tpu/models/yolo.py:28-342`; YOLO11 and YOLO12 from Ultralytics
`ultralytics/cfg/models/11/yolo11.yaml` and `12/yolo12.yaml`, which the JAX
package does not have).

The backbone returns (C3, C4, C5) so MCAQ sits between backbone and neck;
the Detect head emits raw per-scale maps.  Inside the network tensors are
NCHW in channels_last memory; at the public boundary the reference's NHWC
layout is kept: images (B, H, W, 3), raw maps (B, H, W, 4*REG_MAX + nc)
float32.  A variant is a family's name and a scale letter ('yolov8n',
'yolo11l', 'yolo12l', 'rtdetr-l'); any other name raises ValueError.
RT-DETR's head is its decoder, whose output is the last layer's boxes and
logits (`models/rtdetr.py`), post-processed by `rtdetr.select_queries`, not
NMS.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from .. import initializers as init
from ..device import DeviceLike, resolve_device
from ..ops.nms import nms_from_topk, stable_topk
from ..utils.profiling import span
from . import rtdetr
from .layers import (
    C2PSA,
    SPPF,
    A2C2f,
    C2f,
    C3k2,
    ConvBnSiLU,
    SeparableConvBnSiLU,
    upsample2x,
)

# family: scale: (depth_mult, width_mult, max_channels)
FAMILIES = {
    "yolov8": {"n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
               "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512)},
    "yolo11": {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
               "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512)},
    "yolo12": {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
               "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512)},
    "rtdetr": {"l": (1.00, 1.00, 1024)},
}
# the text between a family's name and its scale letter
_SEP = {"rtdetr": "-"}
# variant: (depth_mult, width_mult, max_channels)
VARIANTS = {f + _SEP.get(f, "") + s: v for f, scales in FAMILIES.items()
            for s, v in scales.items()}
# the backbone layers (yaml indices) whose outputs are the neck's C3 / C4 / C5
FEATURE_LAYERS = {"yolov8": [4, 6, 9], "yolo11": [4, 6, 10], "yolo12": [4, 6, 8],
                  "rtdetr": [3, 7, 9]}

REG_MAX = 16
STRIDES = (8, 16, 32)


def family(variant: str) -> str:
    """'yolov8', 'yolo11', 'yolo12' or 'rtdetr' of a variant name;
    ValueError for any other."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {sorted(VARIANTS)}")
    return variant[:-1].rstrip("-")


RTDETR_MISSING = {
    "training": "Hungarian matching, the varifocal loss, denoising query groups and "
                "per-layer auxiliary losses",
    "export": "an exported NMS-free program (export traces decode + NMS)",
}


def refuse_rtdetr(variant: str, what: str) -> None:
    """ValueError, naming what is missing, when `variant` is RT-DETR, whose
    `what` ('training' or 'export') the port does not have."""
    if family(variant) == "rtdetr":
        raise ValueError(f"{variant!r}: RT-DETR {what} is not supported; it needs "
                         f"{RTDETR_MISSING[what]}")


def _ch(base: int, width: float, max_ch: int) -> int:
    """Scaled channel count, rounded up to a multiple of 8."""
    return int(math.ceil(min(base, max_ch) * width / 8) * 8)


def _n(base: int, depth: float) -> int:
    return max(round(base * depth), 1)


def _scaled(variant: str):
    """(depth, channel rule) of a variant."""
    family(variant)
    d, w, mc = VARIANTS[variant]
    return d, lambda b: _ch(b, w, mc)


def variant_channels(variant: str) -> Tuple[int, int, int]:
    """(C3, C4, C5) channel counts of a variant: the backbone's outputs."""
    _, c = _scaled(variant)
    if family(variant) == "rtdetr":
        return rtdetr.variant_channels()
    if family(variant) in ("yolo11", "yolo12"):
        return c(512), c(512), c(1024)
    return c(256), c(512), c(1024)


def head_channels(variant: str) -> Tuple[int, int, int]:
    """The neck's P3 / P4 / P5 channel counts, the head's inputs."""
    _, c = _scaled(variant)
    if family(variant) == "rtdetr":
        return (rtdetr.HIDDEN,) * 3
    return c(256), c(512), c(1024)


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """uint8 (0..255) -> float32 / 255; float inputs pass through."""
    if not x.is_floating_point():
        return x.to(torch.float32) / 255.0
    return x


def images_to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> normalized NCHW channels_last in `dtype`."""
    x = normalize_image(x).permute(0, 3, 1, 2).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


class YOLOv8Backbone(nn.Module):
    """Stem + stages P1..P5 with SPPF; returns (C3, C4, C5)."""

    def __init__(self, variant: str = "yolov8n"):
        super().__init__()
        d, c = _scaled(variant)
        self.ConvBnSiLU_0 = ConvBnSiLU(3, c(64), 3, 2)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(64), c(128), 3, 2)
        self.C2f_0 = C2f(c(128), c(128), _n(3, d), True)
        self.ConvBnSiLU_2 = ConvBnSiLU(c(128), c(256), 3, 2)
        self.C2f_1 = C2f(c(256), c(256), _n(6, d), True)
        self.ConvBnSiLU_3 = ConvBnSiLU(c(256), c(512), 3, 2)
        self.C2f_2 = C2f(c(512), c(512), _n(6, d), True)
        self.ConvBnSiLU_4 = ConvBnSiLU(c(512), c(1024), 3, 2)
        self.C2f_3 = C2f(c(1024), c(1024), _n(3, d), True)
        self.SPPF_0 = SPPF(c(1024), c(1024))

    def forward(self, x, training: bool = False):
        t = training
        x = self.C2f_0(self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, t), t), t)
        c3 = self.C2f_1(self.ConvBnSiLU_2(x, t), t)
        c4 = self.C2f_2(self.ConvBnSiLU_3(c3, t), t)
        c5 = self.SPPF_0(self.C2f_3(self.ConvBnSiLU_4(c4, t), t), t)
        return c3, c4, c5


class YOLOv8Neck(nn.Module):
    """PAN: top-down then bottom-up C2f fusion."""

    def __init__(self, variant: str = "yolov8n"):
        super().__init__()
        d, c = _scaled(variant)
        self.C2f_0 = C2f(c(1024) + c(512), c(512), _n(3, d), False)
        self.C2f_1 = C2f(c(512) + c(256), c(256), _n(3, d), False)
        self.ConvBnSiLU_0 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.C2f_2 = C2f(c(256) + c(512), c(512), _n(3, d), False)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.C2f_3 = C2f(c(512) + c(1024), c(1024), _n(3, d), False)

    def forward(self, c3, c4, c5, training: bool = False):
        t = training
        p4 = self.C2f_0(torch.cat([upsample2x(c5), c4], dim=1), t)
        p3 = self.C2f_1(torch.cat([upsample2x(p4), c3], dim=1), t)
        n4 = self.C2f_2(torch.cat([self.ConvBnSiLU_0(p3, t), p4], dim=1), t)
        n5 = self.C2f_3(torch.cat([self.ConvBnSiLU_1(n4, t), c5], dim=1), t)
        return p3, n4, n5


class YOLO11Backbone(nn.Module):
    """Stem + stages P1..P5 of C3k2 blocks, SPPF and C2PSA; returns (C3, C4,
    C5), the outputs of yaml layers 4, 6 and 10.  The C3k2 blocks hold C3k
    at scales m, l and x (and in layers 6 and 8 at every scale)."""

    def __init__(self, variant: str = "yolo11n"):
        super().__init__()
        d, c = _scaled(variant)
        big = variant[-1] in "mlx"
        n = _n(2, d)
        self.ConvBnSiLU_0 = ConvBnSiLU(3, c(64), 3, 2)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(64), c(128), 3, 2)
        self.C3k2_0 = C3k2(c(128), c(256), n, big, 0.25)
        self.ConvBnSiLU_2 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.C3k2_1 = C3k2(c(256), c(512), n, big, 0.25)
        self.ConvBnSiLU_3 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.C3k2_2 = C3k2(c(512), c(512), n, True)
        self.ConvBnSiLU_4 = ConvBnSiLU(c(512), c(1024), 3, 2)
        self.C3k2_3 = C3k2(c(1024), c(1024), n, True)
        self.SPPF_0 = SPPF(c(1024), c(1024))
        self.C2PSA_0 = C2PSA(c(1024), n)

    def forward(self, x, training: bool = False):
        t = training
        x = self.C3k2_0(self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, t), t), t)
        c3 = self.C3k2_1(self.ConvBnSiLU_2(x, t), t)
        c4 = self.C3k2_2(self.ConvBnSiLU_3(c3, t), t)
        c5 = self.C2PSA_0(self.SPPF_0(self.C3k2_3(self.ConvBnSiLU_4(c4, t), t), t), t)
        return c3, c4, c5


class YOLO11Neck(nn.Module):
    """PAN of C3k2 blocks: top-down then bottom-up fusion."""

    def __init__(self, variant: str = "yolo11n"):
        super().__init__()
        d, c = _scaled(variant)
        big = variant[-1] in "mlx"
        n = _n(2, d)
        c3, c4, c5 = variant_channels(variant)
        self.C3k2_0 = C3k2(c5 + c4, c(512), n, big)
        self.C3k2_1 = C3k2(c(512) + c3, c(256), n, big)
        self.ConvBnSiLU_0 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.C3k2_2 = C3k2(c(256) + c(512), c(512), n, big)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.C3k2_3 = C3k2(c(512) + c5, c(1024), n, True)

    def forward(self, c3, c4, c5, training: bool = False):
        t = training
        p4 = self.C3k2_0(torch.cat([upsample2x(c5), c4], dim=1), t)
        p3 = self.C3k2_1(torch.cat([upsample2x(p4), c3], dim=1), t)
        n4 = self.C3k2_2(torch.cat([self.ConvBnSiLU_0(p3, t), p4], dim=1), t)
        n5 = self.C3k2_3(torch.cat([self.ConvBnSiLU_1(n4, t), c5], dim=1), t)
        return p3, n4, n5


class YOLO12Backbone(nn.Module):
    """Stem, C3k2 stages at P2 and P3, then A2C2f stages of area attention
    at P4 (area 4) and P5 (area 1); no SPPF and no C2PSA.  Returns (C3, C4,
    C5), the outputs of yaml layers 4, 6 and 8.  The C3k2 blocks hold C3k
    at scales m, l and x; at l and x each A2C2f has the layer-scale residual
    and an MLP ratio of 1.2 (2.0 and no residual below)."""

    def __init__(self, variant: str = "yolo12n"):
        super().__init__()
        d, c = _scaled(variant)
        big, lx = variant[-1] in "mlx", variant[-1] in "lx"
        n, r = _n(2, d), 1.2 if lx else 2.0
        self.ConvBnSiLU_0 = ConvBnSiLU(3, c(64), 3, 2)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(64), c(128), 3, 2)
        self.C3k2_0 = C3k2(c(128), c(256), n, big, 0.25)
        self.ConvBnSiLU_2 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.C3k2_1 = C3k2(c(256), c(512), n, big, 0.25)
        self.ConvBnSiLU_3 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.A2C2f_0 = A2C2f(c(512), c(512), _n(4, d), True, 4, lx, r)
        self.ConvBnSiLU_4 = ConvBnSiLU(c(512), c(1024), 3, 2)
        self.A2C2f_1 = A2C2f(c(1024), c(1024), _n(4, d), True, 1, lx, r)

    def forward(self, x, training: bool = False):
        t = training
        x = self.C3k2_0(self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, t), t), t)
        c3 = self.C3k2_1(self.ConvBnSiLU_2(x, t), t)
        c4 = self.A2C2f_0(self.ConvBnSiLU_3(c3, t), t)
        c5 = self.A2C2f_1(self.ConvBnSiLU_4(c4, t), t)
        return c3, c4, c5


class YOLO12Neck(nn.Module):
    """PAN of A2C2f blocks without attention (C3k stages) and a last C3k2:
    top-down then bottom-up fusion."""

    def __init__(self, variant: str = "yolo12n"):
        super().__init__()
        d, c = _scaled(variant)
        n = _n(2, d)
        c3, c4, c5 = variant_channels(variant)
        self.A2C2f_0 = A2C2f(c5 + c4, c(512), n, False)
        self.A2C2f_1 = A2C2f(c(512) + c3, c(256), n, False)
        self.ConvBnSiLU_0 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.A2C2f_2 = A2C2f(c(256) + c(512), c(512), n, False)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.C3k2_0 = C3k2(c(512) + c5, c(1024), n, True)

    def forward(self, c3, c4, c5, training: bool = False):
        t = training
        p4 = self.A2C2f_0(torch.cat([upsample2x(c5), c4], dim=1), t)
        p3 = self.A2C2f_1(torch.cat([upsample2x(p4), c3], dim=1), t)
        n4 = self.A2C2f_2(torch.cat([self.ConvBnSiLU_0(p3, t), p4], dim=1), t)
        n5 = self.C3k2_0(torch.cat([self.ConvBnSiLU_1(n4, t), c5], dim=1), t)
        return p3, n4, n5


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per scale a box branch (2x Conv3x3 ->
    1x1, 4*REG_MAX) and a cls branch (2x Conv3x3 -> 1x1, nc; YOLO11 and
    YOLO12: 2x depthwise 3x3 + 1x1, `SeparableConvBnSiLU`, -> 1x1, nc).
    Returns raw maps (B, H, W, 4*REG_MAX + nc) float32.  Its post-process is
    decode + NMS over a pool of `pre_topk` candidates (`postprocess`)."""

    nms_pool = True

    def __init__(self, num_classes: int = 80, variant: str = "yolov8n"):
        super().__init__()
        chans = head_channels(variant)
        cls_stage = SeparableConvBnSiLU if family(variant) in ("yolo11", "yolo12") else \
            (lambda c_in, c_out: ConvBnSiLU(c_in, c_out, 3))
        c3ch = chans[0]
        c_box = max(16, c3ch // 4, 4 * REG_MAX)
        c_cls = max(c3ch, min(num_classes, 100))
        self.num_classes = num_classes
        for i, cf in enumerate(chans):
            self.add_module(f"box{i}_conv0", ConvBnSiLU(cf, c_box, 3))
            self.add_module(f"box{i}_conv1", ConvBnSiLU(c_box, c_box, 3))
            self.add_module(f"box{i}_out", nn.Conv2d(c_box, 4 * REG_MAX, 1))
            self.add_module(f"cls{i}_conv0", cls_stage(cf, c_cls))
            self.add_module(f"cls{i}_conv1", cls_stage(c_cls, c_cls))
            self.add_module(f"cls{i}_out", nn.Conv2d(c_cls, num_classes, 1))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator):
        for i, s in enumerate(STRIDES):
            # box bias 1.0; cls bias so the initial P(cls) ~ 5 / (nc * anchors)
            cls_prior = 5.0 / self.num_classes / ((640 / s) ** 2)
            box, cls = getattr(self, f"box{i}_out"), getattr(self, f"cls{i}_out")
            init.lecun_normal_(box.weight, g)
            box.bias.fill_(1.0)
            init.lecun_normal_(cls.weight, g)
            cls.bias.fill_(float(-math.log((1.0 - cls_prior) / cls_prior)))

    def postprocess(self, raw, img_hw, conf_threshold: float, iou_threshold: float,
                    max_det: int, pre_topk: int):
        """The deployed post-process of the raw maps: `decode_and_nms` ->
        (boxes, scores, classes, valid, the above-gate candidate count).
        `img_hw` is unused (boxes are in input pixels from the strides)."""
        del img_hw
        return decode_and_nms(raw, self.num_classes, conf_threshold=conf_threshold,
                              iou_threshold=iou_threshold, max_det=max_det,
                              pre_topk=pre_topk, with_pool_stats=True)

    def forward(self, feats: Sequence[torch.Tensor],
                training: bool = False) -> List[torch.Tensor]:
        t = training
        outs = []
        for i, f in enumerate(feats):
            b = getattr(self, f"box{i}_conv1")(getattr(self, f"box{i}_conv0")(f, t), t)
            b = getattr(self, f"box{i}_out")(b)
            c = getattr(self, f"cls{i}_conv1")(getattr(self, f"cls{i}_conv0")(f, t), t)
            c = getattr(self, f"cls{i}_out")(c)
            outs.append(torch.cat([b, c], dim=1).to(torch.float32).permute(0, 2, 3, 1))
        return outs


def init_weights(module: nn.Module, seed: int) -> None:
    """Seeded random init of every submodule that defines init_weights(g),
    in registration order, from one CPU torch.Generator."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(g)


def set_network_dtype(*modules: nn.Module, dtype: torch.dtype) -> None:
    """Convolutions, linear layers and LayerNorms (RT-DETR's) compute in
    `dtype` (weights cast once); BatchNorm keeps float32 statistics and
    parameters, as the reference's flax modules keep float32 params under a
    bf16 compute dtype."""
    for mod in modules:
        for m in mod.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, nn.LayerNorm)):
                m.to(dtype=dtype)


def build_network(variant: str, num_classes: int):
    """(backbone, neck, head) of a variant's family."""
    if family(variant) == "rtdetr":
        return rtdetr.build_network(num_classes)
    backbone, neck = {"yolov8": (YOLOv8Backbone, YOLOv8Neck),
                      "yolo11": (YOLO11Backbone, YOLO11Neck),
                      "yolo12": (YOLO12Backbone, YOLO12Neck)}[family(variant)]
    return backbone(variant), neck(variant), DetectHead(num_classes, variant)


class YOLOv8(nn.Module):
    """Plain (non-MCAQ) detector of any family (`variant`): images (B, H,
    W, 3) -> raw maps.  The float32 teacher of knowledge distillation and
    the base ablation arm."""

    def __init__(self, variant: str = "yolov8n", num_classes: int = 80,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.backbone, self.neck, self.head = build_network(variant, num_classes)
        init_weights(self, seed)
        set_network_dtype(self, dtype=dtype)
        self.to(device=device, memory_format=torch.channels_last)
        self.eval()

    def forward(self, x: torch.Tensor, training: bool = False) -> List[torch.Tensor]:
        c3, c4, c5 = self.features(x, training)
        return self.head(self.neck(c3, c4, c5, training), training)

    def features(self, x: torch.Tensor, training: bool = False):
        """Backbone features (C3, C4, C5), NCHW channels_last: the teacher's
        taps for feature-level distillation."""
        return self.backbone(images_to_nchw(x, self.dtype), training)


# ---------------------------------------------------------------------------
# Anchors, DFL decode, fused decode + NMS
# ---------------------------------------------------------------------------


def make_anchors(feat_shapes, strides=STRIDES, offset: float = 0.5, device=None):
    """Cell-centre anchor points (A, 2) [x, y] in feature units and per-anchor
    strides (A, 1), concatenated over scales."""
    points, strs = [], []
    for (h, w), s in zip(feat_shapes, strides):
        xv = torch.arange(w, dtype=torch.float32, device=device) + offset
        yv = torch.arange(h, dtype=torch.float32, device=device) + offset
        yy, xx = torch.meshgrid(yv, xv, indexing="ij")
        points.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
        strs.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(points, dim=0), torch.cat(strs, dim=0)


def dfl_decode(box_dist: torch.Tensor) -> torch.Tensor:
    """DFL expectation: (..., 4, REG_MAX) logits -> (..., 4) distances."""
    p = torch.softmax(box_dist, dim=-1)
    bins = torch.arange(REG_MAX, dtype=p.dtype, device=p.device)
    return (p * bins).sum(dim=-1)


def decode_predictions(raw_maps: Sequence[torch.Tensor], num_classes: int):
    """Decode every anchor of the raw maps [(B, H, W, 4*REG_MAX + nc)]:
    (boxes xyxy (B, A, 4) in input pixels, scores (B, A, nc) sigmoid, anchor
    points (A, 2), strides (A, 1)).  The input of `ops.nms.batched_nms`."""
    del num_classes  # implied by the raw-map width
    B = raw_maps[0].shape[0]
    points, strides = make_anchors([m.shape[1:3] for m in raw_maps],
                                   device=raw_maps[0].device)
    flat = torch.cat([m.reshape(B, -1, m.shape[-1]) for m in raw_maps], dim=1)
    nreg = 4 * REG_MAX
    dist = dfl_decode(flat[..., :nreg].reshape(B, -1, 4, REG_MAX))
    boxes = torch.cat([(points[None] - dist[..., :2]) * strides[None],
                       (points[None] + dist[..., 2:]) * strides[None]], dim=-1)
    return boxes, torch.sigmoid(flat[..., nreg:]), points, strides


def decode_and_nms(raw_maps: Sequence[torch.Tensor], num_classes: int,
                   conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                   max_det: int = 300, pre_topk: int = 1024,
                   with_pool_stats: bool = False):
    """Deployed decode + NMS over raw maps [(B, H, W, 4*REG_MAX + nc)].

    Top-k over the per-anchor best class LOGIT (ties to the lowest index),
    sigmoid + confidence gate by zeroing, DFL decode of the k survivors
    only, class-aware greedy NMS, compaction to max_det.  Returns (boxes
    (B, max_det, 4), scores, classes int32, valid) [+ gated count (B,)].
    One span, 'decode_and_nms'."""
    del num_classes  # implied by the raw-map width
    with span("decode_and_nms"):
        return _decode_and_nms(raw_maps, conf_threshold, iou_threshold, max_det, pre_topk,
                               with_pool_stats)


def _decode_and_nms(raw_maps, conf_threshold, iou_threshold, max_det, pre_topk,
                    with_pool_stats):
    B = raw_maps[0].shape[0]
    device = raw_maps[0].device
    points, strides = make_anchors([m.shape[1:3] for m in raw_maps], device=device)
    flat = torch.cat([m.reshape(B, -1, m.shape[-1]) for m in raw_maps], dim=1)
    nreg = 4 * REG_MAX

    best_logit = flat[..., nreg:].amax(dim=-1).to(torch.float32)   # (B, A)
    k = min(pre_topk, best_logit.shape[1])
    top_logit, top_idx = stable_topk(best_logit, k)
    top_scores = torch.sigmoid(top_logit)
    top_scores = torch.where(top_scores >= conf_threshold, top_scores,
                             torch.zeros_like(top_scores))

    sel = torch.gather(flat, 1, top_idx[..., None].expand(B, k, flat.shape[-1]))
    top_classes = sel[..., nreg:].argmax(dim=-1).to(torch.int32)
    anc = torch.cat([points, strides], dim=-1)[top_idx]             # (B, k, 3)
    pts, std = anc[..., :2], anc[..., 2:]
    dist = dfl_decode(sel[..., :nreg].reshape(B, k, 4, REG_MAX))
    top_boxes = torch.cat([(pts - dist[..., :2]) * std, (pts + dist[..., 2:]) * std],
                          dim=-1)

    det = nms_from_topk(top_boxes, top_scores, top_classes, iou_threshold=iou_threshold,
                        max_det=max_det)
    if with_pool_stats:
        gated_count = (top_scores > 0.0).sum(dim=-1).to(torch.int32)
        return det + (gated_count,)
    return det
