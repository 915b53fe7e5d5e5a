"""
Plain float32 YOLOv8 (backbone, PAN neck, decoupled Detect head), decode
and a sequential greedy NMS: the benchmark's reference for the network and
the deployed post-processing.

Written from the YOLOv8 description (Ultralytics `ultralytics/cfg/models/v8/
yolov8.yaml`) in the layout of `mcaq_yolo_tpu_torch/models/{layers,yolo}.py`
at commit 00c80e2, so that a state dict made here loads into the measured
program unchanged.  Nothing here imports the program.

BatchNorm follows flax's training rule (biased batch variance, running =
0.97 running + 0.03 batch) and uses the running statistics in eval.  Every
convolution has a `precision`: 'fp32' (the reference) or 'fp8' (the
control: inputs and weights rounded to float8 e4m3 with a per-tensor scale,
the product in float32, the gradient passed straight through).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

VARIANTS = {  # depth, width, max channels (yolov8.yaml `scales`)
    "yolov8n": (0.33, 0.25, 1024),
    "yolov8s": (0.33, 0.50, 1024),
    "yolov8m": (0.67, 0.75, 768),
    "yolov8l": (1.00, 1.00, 512),
    "yolov8x": (1.00, 1.25, 512),
}
REG_MAX = 16
STRIDES = (8, 16, 32)
BN_EPS = 1e-3
BN_MOMENTUM = 0.03
PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def ch(base: int, width: float, max_ch: int) -> int:
    return int(math.ceil(min(base, max_ch) * width / 8) * 8)


def depth(base: int, d: float) -> int:
    return max(round(base * d), 1)


def variant_channels(variant: str) -> Tuple[int, int, int]:
    d, w, mc = VARIANTS[variant]
    return ch(256, w, mc), ch(512, w, mc), ch(1024, w, mc)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale; identity gradient."""
    s = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    q = (t.detach() * s).to(torch.float8_e4m3fn).to(t.dtype) / s
    return t + (q - t.detach())


class Conv(nn.Conv2d):
    precision = "fp32"

    def forward(self, x):
        if self.precision == "fp8":
            return F.conv2d(fp8_round(x), fp8_round(self.weight), self.bias, self.stride,
                            self.padding)
        return super().forward(x)


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x, training: bool = False):
        if not training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            + self.bias[None, :, None, None]


class ConvBnSiLU(nn.Module):
    def __init__(self, c_in, c_out, k=1, s=1, act=True):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_out, k, s, k // 2, bias=False)
        self.BatchNorm_0 = BatchNorm2d(c_out, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x, training=False):
        x = self.BatchNorm_0(self.Conv_0(x), training)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, c_in, c_out, shortcut=True):
        super().__init__()
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, c_out, 3)
        self.ConvBnSiLU_1 = ConvBnSiLU(c_out, c_out, 3)
        self.add = shortcut and c_in == c_out

    def forward(self, x, training=False):
        y = self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, training), training)
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c_in, c_out, n=1, shortcut=False):
        super().__init__()
        self.h = c_out // 2
        self.n = n
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, 2 * self.h, 1)
        for i in range(n):
            self.add_module(f"Bottleneck_{i}", Bottleneck(self.h, self.h, shortcut))
        self.ConvBnSiLU_1 = ConvBnSiLU((2 + n) * self.h, c_out, 1)

    def forward(self, x, training=False):
        y = self.ConvBnSiLU_0(x, training)
        parts = [y[:, :self.h], y[:, self.h:]]
        for i in range(self.n):
            parts.append(getattr(self, f"Bottleneck_{i}")(parts[-1], training))
        return self.ConvBnSiLU_1(torch.cat(parts, 1), training)


class SPPF(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, c_in // 2, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(2 * c_in, c_out, 1)

    def forward(self, x, training=False):
        y = [self.ConvBnSiLU_0(x, training)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        return self.ConvBnSiLU_1(torch.cat(y, 1), training)


def up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class Backbone(nn.Module):
    def __init__(self, variant):
        super().__init__()
        d, w, mc = VARIANTS[variant]
        c = lambda b: ch(b, w, mc)  # noqa: E731
        self.ConvBnSiLU_0 = ConvBnSiLU(3, c(64), 3, 2)
        self.ConvBnSiLU_1 = ConvBnSiLU(c(64), c(128), 3, 2)
        self.C2f_0 = C2f(c(128), c(128), depth(3, d), True)
        self.ConvBnSiLU_2 = ConvBnSiLU(c(128), c(256), 3, 2)
        self.C2f_1 = C2f(c(256), c(256), depth(6, d), True)
        self.ConvBnSiLU_3 = ConvBnSiLU(c(256), c(512), 3, 2)
        self.C2f_2 = C2f(c(512), c(512), depth(6, d), True)
        self.ConvBnSiLU_4 = ConvBnSiLU(c(512), c(1024), 3, 2)
        self.C2f_3 = C2f(c(1024), c(1024), depth(3, d), True)
        self.SPPF_0 = SPPF(c(1024), c(1024))

    def forward(self, x, training=False):
        t = training
        x = self.C2f_0(self.ConvBnSiLU_1(self.ConvBnSiLU_0(x, t), t), t)
        c3 = self.C2f_1(self.ConvBnSiLU_2(x, t), t)
        c4 = self.C2f_2(self.ConvBnSiLU_3(c3, t), t)
        c5 = self.SPPF_0(self.C2f_3(self.ConvBnSiLU_4(c4, t), t), t)
        return c3, c4, c5


class Neck(nn.Module):
    def __init__(self, variant):
        super().__init__()
        d, w, mc = VARIANTS[variant]
        c = lambda b: ch(b, w, mc)  # noqa: E731
        self.C2f_0 = C2f(c(1024) + c(512), c(512), depth(3, d))
        self.C2f_1 = C2f(c(512) + c(256), c(256), depth(3, d))
        self.ConvBnSiLU_0 = ConvBnSiLU(c(256), c(256), 3, 2)
        self.C2f_2 = C2f(c(256) + c(512), c(512), depth(3, d))
        self.ConvBnSiLU_1 = ConvBnSiLU(c(512), c(512), 3, 2)
        self.C2f_3 = C2f(c(512) + c(1024), c(1024), depth(3, d))

    def forward(self, c3, c4, c5, training=False):
        t = training
        p4 = self.C2f_0(torch.cat([up2(c5), c4], 1), t)
        p3 = self.C2f_1(torch.cat([up2(p4), c3], 1), t)
        n4 = self.C2f_2(torch.cat([self.ConvBnSiLU_0(p3, t), p4], 1), t)
        n5 = self.C2f_3(torch.cat([self.ConvBnSiLU_1(n4, t), c5], 1), t)
        return p3, n4, n5


class Head(nn.Module):
    def __init__(self, nc, variant):
        super().__init__()
        chans = variant_channels(variant)
        c_box = max(16, chans[0] // 4, 4 * REG_MAX)
        c_cls = max(chans[0], min(nc, 100))
        self.nc = nc
        for i, cf in enumerate(chans):
            self.add_module(f"box{i}_conv0", ConvBnSiLU(cf, c_box, 3))
            self.add_module(f"box{i}_conv1", ConvBnSiLU(c_box, c_box, 3))
            self.add_module(f"box{i}_out", Conv(c_box, 4 * REG_MAX, 1))
            self.add_module(f"cls{i}_conv0", ConvBnSiLU(cf, c_cls, 3))
            self.add_module(f"cls{i}_conv1", ConvBnSiLU(c_cls, c_cls, 3))
            self.add_module(f"cls{i}_out", Conv(c_cls, nc, 1))

    def forward(self, feats, training=False):
        """-> raw maps [(B, H, W, 4 * REG_MAX + nc)] float32."""
        outs = []
        for i, f in enumerate(feats):
            b = getattr(self, f"box{i}_out")(getattr(self, f"box{i}_conv1")(
                getattr(self, f"box{i}_conv0")(f, training), training))
            c = getattr(self, f"cls{i}_out")(getattr(self, f"cls{i}_conv1")(
                getattr(self, f"cls{i}_conv0")(f, training), training))
            outs.append(torch.cat([b, c], 1).permute(0, 2, 3, 1))
        return outs


class YOLOv8(nn.Module):
    """The plain YOLOv8: (B, H, W, 3) uint8 -> raw maps.  The teacher."""

    def __init__(self, variant="yolov8n", nc=80):
        super().__init__()
        self.backbone = Backbone(variant)
        self.neck = Neck(variant)
        self.head = Head(nc, variant)

    def features(self, x, training=False):
        return self.backbone(to_nchw(x), training)

    def forward(self, x, training=False):
        return self.head(self.neck(*self.features(x, training), training), training)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point():
        x = x.to(torch.float32) / 255.0
    return x.permute(0, 3, 1, 2).contiguous()


def set_precision(model: nn.Module, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    for m in model.modules():
        if isinstance(m, Conv):
            m.precision = precision


# ---------------------------------------------------------------------------
# Decode and NMS
# ---------------------------------------------------------------------------


def make_anchors(shapes, device):
    pts, strs = [], []
    for (h, w), s in zip(shapes, STRIDES):
        yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32) + 0.5,
                                torch.arange(w, device=device, dtype=torch.float32) + 0.5,
                                indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
        strs.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(strs)


def dfl(dist: torch.Tensor) -> torch.Tensor:
    p = torch.softmax(dist, dim=-1)
    return (p * torch.arange(REG_MAX, device=dist.device, dtype=p.dtype)).sum(-1)


def flatten_maps(raw: Sequence[torch.Tensor]) -> torch.Tensor:
    B = raw[0].shape[0]
    return torch.cat([m.reshape(B, -1, m.shape[-1]) for m in raw], 1)


def decode(raw: Sequence[torch.Tensor], dtype=torch.float32):
    """Every anchor: (boxes xyxy pixels (B, A, 4), class logits (B, A, nc)),
    computed in `dtype`."""
    flat = flatten_maps(raw).to(dtype)
    B = flat.shape[0]
    pts, strs = make_anchors([m.shape[1:3] for m in raw], flat.device)
    d = dfl(flat[..., :4 * REG_MAX].reshape(B, -1, 4, REG_MAX))
    boxes = torch.cat([pts.to(dtype) - d[..., :2], pts.to(dtype) + d[..., 2:]], -1) * strs.to(dtype)
    return boxes, flat[..., 4 * REG_MAX:]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + 1e-7)


def detect(raw: Sequence[torch.Tensor], conf: float, iou: float, max_det: int, pool: int,
           dtype=torch.float32):
    """Decode + class-aware greedy NMS: the `pool` anchors with the highest
    best-class logit (ties to the lower index) are the candidates; those
    below `conf` drop out; a candidate is kept unless a kept candidate of
    its class with a higher score overlaps it above `iou`.  -> (boxes
    (B, max_det, 4), scores, classes, valid), kept candidates first in
    score order.  Decode and suppression compute in `dtype`."""
    boxes, logits = decode(raw, dtype)
    B, A, _ = boxes.shape
    best, cls = logits.max(-1)
    order = torch.sort(best, dim=1, descending=True, stable=True).indices[:, :pool]
    k = order.shape[1]
    score = torch.sigmoid(torch.gather(best, 1, order))
    cls = torch.gather(cls, 1, order)
    bx = torch.gather(boxes, 1, order[..., None].expand(B, k, 4))
    alive = score >= conf
    same = cls[:, :, None] == cls[:, None, :]
    over = (box_iou(bx, bx) > iou) & same
    keep = torch.zeros_like(alive)
    for i in range(k):  # in score order: suppressed by any kept, earlier candidate
        hit = (keep[:, :i] & over[:, :i, i]).any(1) if i else torch.zeros_like(alive[:, 0])
        keep[:, i] = alive[:, i] & ~hit
    s = torch.where(keep, score, torch.zeros_like(score))
    out = torch.sort(s, dim=1, descending=True, stable=True)
    n = min(max_det, k)
    o = out.indices[:, :n]
    res = (torch.gather(bx, 1, o[..., None].expand(B, n, 4)), out.values[:, :n],
           torch.gather(cls, 1, o), out.values[:, :n] > 0)
    if max_det > n:
        pad = max_det - n
        res = (F.pad(res[0], (0, 0, 0, pad)), F.pad(res[1], (0, pad)),
               F.pad(res[2], (0, pad)), F.pad(res[3], (0, pad)))
    return res


def conv_flops(model: nn.Module, x: torch.Tensor) -> int:
    """2 x multiply-accumulates of every convolution of one forward of
    `model` on `x` (any device, `meta` included)."""
    total = [0]

    def hook(m, inp, out):
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size)

    hs = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, nn.Conv2d)]
    try:
        model(x)
    finally:
        for h in hs:
            h.remove()
    return total[0]

