"""
YOLOv8 detection model family (n/s/m/l/x) and the deployed decode + NMS
(port of `mcaq_yolo_tpu/models/yolo.py:28-342`).

The backbone returns (C3, C4, C5) so MCAQ sits between backbone and neck;
the Detect head emits raw per-scale maps.  Inside the network tensors are
NCHW in channels_last memory; at the public boundary the reference's NHWC
layout is kept: images (B, H, W, 3), raw maps (B, H, W, 4*REG_MAX + nc)
float32.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from .. import initializers as init
from ..device import DeviceLike, resolve_device
from ..ops.nms import nms_from_topk, stable_topk
from .layers import SPPF, C2f, ConvBnSiLU, upsample2x

# variant: (depth_mult, width_mult, max_channels)
VARIANTS = {
    "yolov8n": (0.33, 0.25, 1024),
    "yolov8s": (0.33, 0.50, 1024),
    "yolov8m": (0.67, 0.75, 768),
    "yolov8l": (1.00, 1.00, 512),
    "yolov8x": (1.00, 1.25, 512),
}

REG_MAX = 16
STRIDES = (8, 16, 32)


def _ch(base: int, width: float, max_ch: int) -> int:
    """Scaled channel count, rounded up to a multiple of 8."""
    return int(math.ceil(min(base, max_ch) * width / 8) * 8)


def _n(base: int, depth: float) -> int:
    return max(round(base * depth), 1)


def variant_channels(variant: str) -> Tuple[int, int, int]:
    """(C3, C4, C5) channel counts of a variant."""
    d, w, mc = VARIANTS[variant]
    return _ch(256, w, mc), _ch(512, w, mc), _ch(1024, w, mc)


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
        d, w, mc = VARIANTS[variant]
        c = lambda b: _ch(b, w, mc)  # noqa: E731
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
        d, w, mc = VARIANTS[variant]
        c = lambda b: _ch(b, w, mc)  # noqa: E731
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


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per scale a box branch (2x Conv3x3 ->
    1x1, 4*REG_MAX) and a cls branch (2x Conv3x3 -> 1x1, nc).  Returns raw
    maps (B, H, W, 4*REG_MAX + nc) float32."""

    def __init__(self, num_classes: int = 80, variant: str = "yolov8n"):
        super().__init__()
        d, w, mc = VARIANTS[variant]
        chans = variant_channels(variant)
        c3ch = chans[0]
        c_box = max(16, c3ch // 4, 4 * REG_MAX)
        c_cls = max(c3ch, min(num_classes, 100))
        self.num_classes = num_classes
        for i, cf in enumerate(chans):
            self.add_module(f"box{i}_conv0", ConvBnSiLU(cf, c_box, 3))
            self.add_module(f"box{i}_conv1", ConvBnSiLU(c_box, c_box, 3))
            self.add_module(f"box{i}_out", nn.Conv2d(c_box, 4 * REG_MAX, 1))
            self.add_module(f"cls{i}_conv0", ConvBnSiLU(cf, c_cls, 3))
            self.add_module(f"cls{i}_conv1", ConvBnSiLU(c_cls, c_cls, 3))
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
    """Convolutions compute in `dtype` (weights cast once); BatchNorm keeps
    float32 statistics and parameters, as the reference's flax modules keep
    float32 params under a bf16 compute dtype."""
    for mod in modules:
        for m in mod.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype=dtype)


class YOLOv8(nn.Module):
    """Plain (non-MCAQ) YOLOv8: images (B, H, W, 3) -> raw maps.  The
    float32 teacher of knowledge distillation and the base ablation arm."""

    def __init__(self, variant: str = "yolov8n", num_classes: int = 80,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.backbone = YOLOv8Backbone(variant)
        self.neck = YOLOv8Neck(variant)
        self.head = DetectHead(num_classes, variant)
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


def decode_and_nms(raw_maps: Sequence[torch.Tensor], num_classes: int,
                   conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                   max_det: int = 300, pre_topk: int = 1024,
                   with_pool_stats: bool = False):
    """Deployed decode + NMS over raw maps [(B, H, W, 4*REG_MAX + nc)].

    Top-k over the per-anchor best class LOGIT (ties to the lowest index),
    sigmoid + confidence gate by zeroing, DFL decode of the k survivors
    only, class-aware greedy NMS, compaction to max_det.  Returns (boxes
    (B, max_det, 4), scores, classes int32, valid) [+ gated count (B,)]."""
    del num_classes  # implied by the raw-map width
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
