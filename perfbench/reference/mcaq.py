"""
Plain float32 MCAQ transform and the MCAQ-YOLO assembly: the benchmark's
reference for the morphology (Algorithm 1: gray preparation, per-tile phi1-5
with the cv2-compatible Canny, adaptive binarization and Euler-corrected
contours, the complexity MLP, the bilateral filter), the monotone bit mapper
(Eq.13-18), the soft mask and the spatial quantizer (Eq.19: integer bits in
eval, the fractional compose with its EMA ranges in training).

A frozen copy of the plain PyTorch paths of `mcaq_yolo_tpu_torch/core/
{image_ops,morphology,bit_allocation,quantization}.py` and `ops/
spatial_quant.py:spatial_quantize_torch` at commit 00c80e2, cut to the
deployed options, with the program's module and buffer names so that a
state dict made here loads into it.  It imports nothing of the program and
runs no hand-written kernel.  The MCAQ math runs in float32 (TF32 off: the
caller sets `torch.backends.*.allow_tf32`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .network import Backbone, Head, Neck, to_nchw, variant_channels

MIN_BITS, MAX_BITS = 2, 8
EMA_MOMENTUM = 0.99

# ---------------------------------------------------------------------------
# Map operators: (N, H, W) float32
# ---------------------------------------------------------------------------


def pad(x, p, mode):
    if mode == "edge":
        return F.pad(x[:, None], (p, p, p, p), mode="replicate")[:, 0]
    return F.pad(x, (p, p, p, p), value=1.0 if mode == "one" else 0.0)


def shifted(xp, p, dy, dx):
    H, W = xp.shape[1] - 2 * p, xp.shape[2] - 2 * p
    return xp[:, p + dy:p + dy + H, p + dx:p + dx + W]


def shift(x, dy, dx, mode):
    p = max(abs(dy), abs(dx))
    return x if p == 0 else shifted(pad(x, p, mode), p, dy, dx)


def gaussian_taps(k, sigma):
    g = torch.exp(-(torch.arange(k, dtype=torch.float32) - k // 2) ** 2 / (2 * sigma ** 2))
    return tuple(float(v) for v in g / g.sum())


def sep_filter(x, taps, mode):
    r = len(taps) // 2
    xp, out = pad(x, r, mode), None
    for i, w in enumerate(taps):
        s = shifted(xp, r, i - r, 0) * w
        out = s if out is None else out + s
    op, res = pad(out, r, mode), None
    for i, w in enumerate(taps):
        s = shifted(op, r, 0, i - r) * w
        res = s if res is None else res + s
    return res


def sobel(x, mode="edge"):
    def pass1(v, taps, axis):
        vp, out = pad(v, 1, mode), None
        for i, w in enumerate(taps):
            s = shifted(vp, 1, *((i - 1, 0) if axis == 0 else (0, i - 1))) * w
            out = s if out is None else out + s
        return out

    return (pass1(pass1(x, (1.0, 2.0, 1.0), 0), (-1.0, 0.0, 1.0), 1),
            pass1(pass1(x, (1.0, 2.0, 1.0), 1), (-1.0, 0.0, 1.0), 0))


def dilate3(x):
    m = torch.maximum(torch.maximum(shift(x, -1, 0, "zero"), x), shift(x, 1, 0, "zero"))
    return torch.maximum(torch.maximum(shift(m, 0, -1, "zero"), m), shift(m, 0, 1, "zero"))


def erode3(x):
    m = torch.minimum(torch.minimum(shift(x, -1, 0, "one"), x), shift(x, 1, 0, "one"))
    return torch.minimum(torch.minimum(shift(m, 0, -1, "one"), m), shift(m, 0, 1, "one"))


def otsu(x, bins=256):
    """Per-tile Otsu of (N, t, t) in [0, 1] -> (N, 1, 1), ties to the lower bin."""
    N, t, _ = x.shape
    n = t * t
    idx = torch.clamp((x * bins).to(torch.int32), 0, bins - 1)
    v = torch.sort(idx.reshape(N, n), dim=1).values
    centers = (v.to(torch.float32) + 0.5) / bins
    p = 1.0 / n
    omega = (torch.arange(1, n + 1, dtype=torch.float32, device=x.device) * p)[None]
    mu = torch.cumsum(centers * p, dim=1)
    sigma_b = (mu[:, -1:] * omega - mu) ** 2 / (omega * (1.0 - omega) + 1e-12)
    boundary = torch.cat([v[:, :-1] != v[:, 1:],
                          torch.ones((N, 1), dtype=torch.bool, device=x.device)], 1)
    sigma_b = torch.where(boundary, sigma_b, torch.full_like(sigma_b, -1.0))
    thr = torch.gather(v, 1, torch.argmax(sigma_b, dim=1, keepdim=True))
    return ((thr.to(torch.float32) + 0.5) / bins)[:, :, None]


def canny(tiles, iters=8):
    """cv2-compatible per-tile Canny: 0..255, 5x5 Gaussian sigma 1, Otsu of
    the blur (high) and half of it (low), L1 magnitude, 4-direction NMS,
    `iters` hysteresis dilations."""
    b01 = sep_filter(tiles, gaussian_taps(5, 1.0), "edge")
    thr = otsu(b01) * 255.0
    gx, gy = sobel(b01 * 255.0)
    mag = gx.abs() + gy.abs()
    angle = torch.atan2(gy, gx) * (180.0 / math.pi)
    angle = torch.where(angle < 0, angle + 180.0, angle)
    mp = pad(mag, 1, "edge")
    nms = torch.zeros_like(mag)
    for sel, a, b in (((angle < 22.5) | (angle >= 157.5), (0, 1), (0, -1)),
                      ((angle >= 22.5) & (angle < 67.5), (-1, 1), (1, -1)),
                      ((angle >= 67.5) & (angle < 112.5), (-1, 0), (1, 0)),
                      ((angle >= 112.5) & (angle < 157.5), (-1, -1), (1, 1))):
        keep = (mag >= shifted(mp, 1, *a)) & (mag >= shifted(mp, 1, *b))
        nms = torch.where(sel & keep, mag, nms)
    edge, weak = (nms > thr).to(tiles.dtype), nms > 0.5 * thr
    for _ in range(iters):
        edge = torch.where(weak & (dilate3(edge) > 0), torch.ones_like(edge), edge)
    return edge


def adaptive_binarize(tiles, block=11, C=2.0):
    g = tiles * 255.0
    sigma = 0.3 * ((block - 1) * 0.5 - 1) + 0.8
    return (g > sep_filter(g, gaussian_taps(block, sigma), "edge") - C).to(tiles.dtype)


def tile_sum(x):
    v = x.reshape(x.shape[0], -1)
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0]


def scale_sum(t):
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def fractal_dimension(edge, tile):
    scales = []
    s = 2
    while s <= tile:
        scales.append(s)
        s *= 2
    if len(scales) < 2:
        return torch.ones(edge.shape[0], dtype=torch.float32, device=edge.device)
    n = torch.stack([F.max_pool2d(edge[:, None], s).sum(dim=(1, 2, 3)) for s in scales])
    S = len(scales)
    shape = (S, 1)
    x = torch.log((2 ** torch.arange(1, S + 1, device=edge.device)).to(torch.float32)
                  ).reshape(shape)
    y = torch.log(n + 1.0)
    w = torch.exp(-0.1 * torch.arange(S, dtype=torch.float32, device=edge.device)).reshape(shape)
    ws = scale_sum(w)
    xm, ym = scale_sum(w * x) / ws, scale_sum(w * y) / ws
    cov = scale_sum(w * (x - xm) * (y - ym))
    var = scale_sum(w * (x - xm) ** 2)
    return torch.clamp(-(cov / (var + 1e-12)), 1.0, 2.0)


LBP = [(-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)]


def lbp_entropy(tiles):
    xp = pad(tiles, 1, "edge")
    bits = [(shifted(xp, 1, dy, dx) >= tiles).to(torch.float32) for dy, dx in LBP]
    ones = sum(bits)
    trans = sum(torch.abs(bits[i] - bits[i - 1]) for i in range(8))
    label = torch.where(trans <= 2.0, ones, torch.full_like(ones, 9.0))
    n = tiles.shape[1] * tiles.shape[2]
    ent = None
    for v in range(10):
        p = (label == v).to(torch.float32).sum(dim=(1, 2)) / n
        term = p * torch.log2(p + 1e-10)
        ent = -term if ent is None else ent - term
    return ent * (1.0 / math.log2(10.0))


def gradient_variance(gx, gy):
    n = gx.shape[1] * gx.shape[2]

    def var(t):
        m = tile_sum(t) / n
        return torch.clamp(tile_sum(t * t) / n - m * m, min=0.0)

    v = var(gx) + var(gy)
    return v / (v + 1.0)


def contour_complexity(m):
    """Eq.(24) with the Euler component count K (Gray's quad patterns)."""
    boundary = torch.clamp(m - erode3(m), min=0.0)
    mp = F.pad(m, (1, 1, 1, 1))
    idx = (mp[:, :-1, :-1] + 2.0 * mp[:, :-1, 1:] + 4.0 * mp[:, 1:, :-1]
           + 8.0 * mp[:, 1:, 1:]).to(torch.int32)
    count = lambda vals: sum((idx == v).to(torch.float32) for v in vals)  # noqa: E731
    euler = (count([1, 2, 4, 8]) - count([7, 11, 13, 14]) - 2.0 * count([6, 9])) / 4.0
    K = torch.clamp(torch.round(euler.sum(dim=(1, 2))), min=1.0)
    area, perim = m.sum(dim=(1, 2)), boundary.sum(dim=(1, 2))
    ic = (perim * perim) / (4.0 * math.pi * area + 1e-6) / K
    phi5 = 1.0 - 1.0 / torch.clamp(ic, min=1.0)
    return torch.where(area > 0, phi5, torch.zeros_like(phi5))


def tile_size_for(H, grid):
    raw = max(4, H // grid)
    tile = 1 << (raw.bit_length() - 1)
    if tile > H:
        tile = max(1, 1 << (H.bit_length() - 1))
    return tile


def gray_geometry(H: int, W: int, grid: int, downsample: int):
    """(rows, cols) of the map's whole tiles, the pool factor and the tile
    the metrics run on, for a scale of H x W."""
    tile = tile_size_for(H, grid)
    ds = downsample
    while ds > 1 and tile // ds < 4:
        ds //= 2
    return (H // tile) * tile, (W // tile) * tile, ds, tile // ds


def prepare_gray(f, grid, downsample):
    """f (B, H, W, C) -> (min-max normalized gray (B, Hg, Wg), tile)."""
    Hc, Wc, ds, tile = gray_geometry(f.shape[1], f.shape[2], grid, downsample)
    gray = f[:, :Hc, :Wc].to(torch.float32).mean(-1)
    if ds > 1:
        gray = F.avg_pool2d(gray[:, None], ds)[:, 0]
    lo = gray.amin(dim=(1, 2), keepdim=True)
    hi = gray.amax(dim=(1, 2), keepdim=True)
    return (gray - lo) / (hi - lo + 1e-8), tile


def phi(gray, tile):
    """gray (B, Hc, Wc) -> phi (B, ht, wt, 8)."""
    B, Hc, Wc = gray.shape
    ht, wt = Hc // tile, Wc // tile
    t = gray.reshape(B, ht, tile, wt, tile).permute(0, 1, 3, 2, 4).reshape(-1, tile, tile)
    gx, gy = sobel(t)
    edge = canny(t)
    p1 = fractal_dimension(edge, tile) / 2.0
    p2, p3 = lbp_entropy(t), gradient_variance(gx, gy)
    p4, p5 = edge.mean(dim=(1, 2)), contour_complexity(adaptive_binarize(t))
    out = torch.stack([p1, p2, p3, p4, p5, p1 * p2, p3 ** 2, torch.sqrt(p4 * p5 + 1e-12)], -1)
    return out.reshape(B, ht, wt, 8)


def spatial_weights(k, sigma):
    p = k // 2
    return [math.exp(-(dy * dy + dx * dx) / (2.0 * sigma ** 2))
            for dy in range(-p, p + 1) for dx in range(-p, p + 1)]


def bilateral(c, sigma_s=2.0, sigma_r=0.1, k=5):
    B, H, W = c.shape
    p = k // 2
    xp = pad(c, p, "edge")
    patches = torch.stack([xp[:, p + dy:p + dy + H, p + dx:p + dx + W]
                           for dy in range(-p, p + 1) for dx in range(-p, p + 1)], -1)
    sw = torch.tensor(spatial_weights(k, sigma_s), dtype=torch.float32, device=c.device)
    w = sw * torch.exp(-((patches - c[..., None]) ** 2) / (2.0 * sigma_r ** 2))
    return (w * patches).sum(-1) / (w.sum(-1) + 1e-8)


class ComplexityMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(8, 64)
        self.LayerNorm_0 = nn.LayerNorm(64, eps=1e-5)
        self.Dense_1 = nn.Linear(64, 32)
        self.LayerNorm_1 = nn.LayerNorm(32, eps=1e-5)
        self.Dense_2 = nn.Linear(32, 1)

    def forward(self, x):
        x = F.relu(self.LayerNorm_0(self.Dense_0(x)))
        x = F.relu(self.LayerNorm_1(self.Dense_1(x)))
        return torch.sigmoid(self.Dense_2(x))


class Analyzer(nn.Module):
    """features (B, H, W, C) -> complexity (B, ht, wt) in [0, 1]."""

    def __init__(self, grid=8, downsample=1):
        super().__init__()
        self.grid, self.downsample = grid, downsample
        self.complexity_mlp = ComplexityMLP()
        self.register_buffer("feature_weights", torch.full((5,), 0.2))

    def phi(self, f):
        with torch.no_grad():
            gray, tile = prepare_gray(f, self.grid, self.downsample)
            return phi(gray, tile)

    def forward(self, f):
        p = self.phi(f)
        B, ht, wt, _ = p.shape
        c = self.complexity_mlp(p.reshape(-1, 8)).reshape(B, ht, wt)
        return torch.clamp(bilateral(c), 0.0, 1.0)


def ste(x, fx):
    return x + (fx - x).detach()


class BatchNorm1d(nn.BatchNorm1d):
    """flax's arithmetic: var = max(0, E[x^2] - E[x]^2), running = 0.9 r + 0.1 b."""

    def forward(self, x, training=False):
        if not training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        mean, mean2 = x.mean(0), (x * x).mean(0)
        var = torch.maximum(mean2 - mean * mean, x.new_zeros(()))
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MonotoneDense(nn.Module):
    def __init__(self, n_in, n_out):
        super().__init__()
        self.theta = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.full((n_out,), 0.1))

    def forward(self, x):
        return x @ F.softplus(self.theta) + self.bias


class BitMapper(nn.Module):
    """[C, C^2, log1p C] -> 32 -> 64 -> 32 -> 1 (softplus kernels, BatchNorm,
    leaky ReLU 0.05), sigmoid to [2, 8], x temperature (floored at 0.1),
    straight-through clamp and, in eval, round."""

    def __init__(self, hidden=(32, 64, 32)):
        super().__init__()
        dims = (3,) + tuple(hidden) + (1,)
        for i in range(len(dims) - 1):
            self.add_module(f"MonotoneDense_{i}", MonotoneDense(dims[i], dims[i + 1]))
        for i, d in enumerate(hidden):
            self.add_module(f"BatchNorm_{i}", BatchNorm1d(d, eps=1e-5, momentum=0.1))
        self.n_hidden = len(hidden)

    def dense(self, i):
        return getattr(self, f"MonotoneDense_{i}")

    def forward(self, c, temperature, continuous=False, training=False):
        c = torch.clamp(c, 0.0, 1.0)
        B, H, W = c.shape
        z = c.reshape(-1, 1)
        h = torch.cat([z, z ** 2, torch.log1p(z)], -1)
        for i in range(self.n_hidden):
            h = F.leaky_relu(getattr(self, f"BatchNorm_{i}")(self.dense(i)(h), training), 0.05)
        h = torch.sigmoid(self.dense(self.n_hidden)(h))
        b = (MIN_BITS + (MAX_BITS - MIN_BITS) * h).reshape(B, H, W)
        b = b * float(max(float(torch.tensor(temperature, dtype=torch.float32)), 0.1))
        b = ste(b, torch.clamp(b, MIN_BITS, MAX_BITS))
        return b if continuous else ste(b, torch.round(b))


def upsample_nearest(x, size):
    H, W = size
    Ht, Wt = x.shape[1], x.shape[2]
    if H % Ht == 0 and W % Wt == 0:
        return x.repeat_interleave(H // Ht, 1).repeat_interleave(W // Wt, 2)
    ri = torch.arange(H, device=x.device) * Ht // H
    ci = torch.arange(W, device=x.device) * Wt // W
    return x[:, ri][:, :, ci]


def gaussian_blur_edge(x, k, sigma):
    g = torch.exp(-(torch.arange(k, dtype=torch.float32, device=x.device) - k // 2) ** 2
                  / (2.0 * sigma ** 2))
    g = g / g.sum()
    xp = F.pad(x[:, None], (k // 2,) * 4, mode="replicate")
    return F.conv2d(xp, (g[:, None] * g[None, :])[None, None])[:, 0]


def clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


class SoftMask(nn.Module):
    def __init__(self, hidden=8, k=5):
        super().__init__()
        self.k = k
        self.Conv_0 = nn.Conv2d(2, hidden, 3, padding=1)
        self.Conv_1 = nn.Conv2d(hidden, 2, 1)

    def forward(self, bit_map, x):
        """bit_map (B, Ht, Wt), x (B, H, W, C) -> m (B, H, W, 1)."""
        B, H, W, C = x.shape
        Ht = bit_map.shape[1]
        act = x.detach().abs().mean(-1, dtype=torch.float32)
        act = F.avg_pool2d(act[:, None], H // Ht)[:, 0]
        act = act / (act.amax(dim=(1, 2), keepdim=True) + 1e-8)
        bits = clip((bit_map.to(torch.float32) - 2.0) / 6.0, 0.0, 1.0)
        m = torch.softmax(self.Conv_1(F.relu(self.Conv_0(torch.stack([bits, act], 1)))), 1)[:, 0]
        return gaussian_blur_edge(upsample_nearest(m, (H, W)), self.k, self.k / 3.0)[..., None]


def qparams(x_min, x_max, bits):
    """scale and zero point of signed `bits`-bit quantization (per channel)."""
    half = 2.0 ** (bits - 1)
    qmin, d = -half, 2.0 * half - 1.0
    scale = torch.clamp(x_max - x_min, min=1e-8) / d
    return scale, torch.clamp(qmin - x_min / scale, qmin, qmin + d), qmin, qmin + d


def quantize_integer(x, bit_map, x_min, x_max, mask):
    """Eval compose: every pixel at its tile's rounded bit width, x mask."""
    B, H, W, C = x.shape
    bits = torch.clamp(torch.round(bit_map.to(torch.float32)), MIN_BITS, MAX_BITS)
    b = upsample_nearest(bits, (H, W))[..., None]
    half = torch.pow(2.0, b - 1.0)
    qmin, d = -half, 2.0 * half - 1.0
    scale = torch.clamp(x_max - x_min, min=1e-8) / d
    zp = torch.clamp(qmin - x_min / scale, qmin, qmin + d)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale + zp), qmin, qmin + d)
    return (q - zp) * scale * mask


def fake_quantize(x, x_min, x_max, bits):
    scale, zp, qmin, qmax = qparams(x_min.detach(), x_max.detach(), bits)
    q = torch.clamp(torch.round(x / scale + zp), qmin, qmax)
    return ste(x, (q - zp) * scale)


def quantize_fractional(x, bit_map, x_min, x_max):
    """Training compose: (1 - frac) Q_floor + frac Q_ceil per tile."""
    H, W = x.shape[1:3]
    b_floor = torch.floor(bit_map.detach())
    frac = upsample_nearest(bit_map - b_floor, (H, W))[..., None]
    qs = {b: fake_quantize(x, x_min, x_max, b) for b in range(MIN_BITS, MAX_BITS + 1)}
    out = torch.zeros_like(x)
    for b in range(MIN_BITS, MAX_BITS + 1):
        sel = upsample_nearest((b_floor == b).to(x.dtype), (H, W))[..., None]
        out = out + sel * ((1.0 - frac) * qs[b] + frac * qs[min(b + 1, MAX_BITS)])
    return out


class Quantizer(nn.Module):
    """Per-channel min/max ranges: the batch's until an EMA state exists
    (training) or the quantizer is frozen (eval); soft mask on."""

    def __init__(self, C):
        super().__init__()
        self.register_buffer("running_min", torch.zeros(C))
        self.register_buffer("running_max", torch.zeros(C))
        self.register_buffer("num_batches", torch.zeros((), dtype=torch.int32))
        self.register_buffer("frozen", torch.zeros((), dtype=torch.bool))
        self.soft_mask = SoftMask()

    @staticmethod
    def batch_range(x):
        flat = x.reshape(-1, x.shape[-1])
        return flat.amin(0).to(torch.float32), flat.amax(0).to(torch.float32)

    def forward(self, x, bit_map, training=False, batch_range=None):
        """x (B, H, W, C) float32.  `batch_range`: the whole batch's
        per-channel (min, max) when x is one block of it."""
        lo, hi = batch_range if batch_range is not None else self.batch_range(x)
        if training:
            with torch.no_grad():
                m = EMA_MOMENTUM
                first = int(self.num_batches) == 0
                self.running_min.copy_(lo if first else m * self.running_min + (1 - m) * lo)
                self.running_max.copy_(hi if first else m * self.running_max + (1 - m) * hi)
                self.num_batches.add_(1)
            xq = quantize_fractional(x, bit_map, self.running_min, self.running_max)
            return xq * self.soft_mask(bit_map, x)
        if bool(self.frozen) and int(self.num_batches) > 0:
            lo, hi = self.running_min, self.running_max
        with torch.no_grad():
            mask = self.soft_mask(bit_map, x)
            return quantize_integer(x, bit_map, lo, hi, mask)


class MCAQYOLO(nn.Module):
    """YOLOv8 with the MCAQ transform on C3 / C4 / C5 before the neck."""

    def __init__(self, variant="yolov8n", nc=80, grid=8, downsample=1):
        super().__init__()
        self.backbone = Backbone(variant)
        self.neck = Neck(variant)
        self.head = Head(nc, variant)
        self.complexity_analyzer = Analyzer(grid, downsample)
        self.bit_mapper = BitMapper()
        for i, c in enumerate(variant_channels(variant)):
            self.add_module(f"quantizer_p{i + 3}", Quantizer(c))

    def quantizer(self, i) -> Quantizer:
        return getattr(self, f"quantizer_p{i + 3}")

    def transform(self, f, i, temperature, training=False, batch_range=None, bit_map=None):
        """f NCHW float32 -> (quantized NCHW, complexity, bit map).  A given
        `bit_map` is quantized with in place of the mapper's, which is still
        computed and returned."""
        x = f.permute(0, 2, 3, 1)
        c = self.complexity_analyzer(x)
        b = self.bit_mapper(c, temperature, continuous=training, training=training)
        xq = self.quantizer(i)(x, b if bit_map is None else bit_map, training, batch_range)
        return xq.permute(0, 3, 1, 2), c, b

    def forward(self, x, temperature=1.0, training=False):
        """-> (raw maps, aux: complexity, bit maps, quantized features NHWC,
        avg_bits)."""
        feats = self.backbone(to_nchw(x), training)
        out = [self.transform(f, i, temperature, training) for i, f in enumerate(feats)]
        raw = self.head(self.neck(*[o[0] for o in out], training), training)
        bits = [o[2] for o in out]
        return raw, {"complexity": [o[1] for o in out], "bit_map": bits,
                     "quantized": [o[0].permute(0, 2, 3, 1) for o in out],
                     "avg_bits": torch.stack([b.mean() for b in bits]).mean()}

    @torch.no_grad()
    def forward_blocks(self, x, temperature=1.0, block=32, feats=None, bit_maps=None) -> Dict:
        """The eval forward of a whole batch in blocks of `block` images, so
        it fits beside what the caller holds: the quantizers' per-channel
        ranges are the whole batch's, as one call takes them.  Given `feats`
        (the backbone's C3 / C4 / C5, NCHW) it starts from them, and given
        `bit_maps` it quantizes with them (the analyzer and the mapper still
        run on the features: `complexity` and `bits` are its own).  -> dict
        of the raw maps, backbone features, complexity and bit maps, and
        avg_bits."""
        if feats is None:
            feats = [[] for _ in range(3)]
            for s in range(0, x.shape[0], block):
                for i, f in enumerate(self.backbone(to_nchw(x[s:s + block]))):
                    feats[i].append(f)
            feats = [torch.cat(f) for f in feats]
        feats = [f.to(torch.float32) for f in feats]
        ranges = []
        for f in feats:
            flat = f.permute(0, 2, 3, 1).reshape(-1, f.shape[1])
            ranges.append((flat.amin(0), flat.amax(0)))
        raw, cmaps, bmaps = [[], [], []], [[], [], []], [[], [], []]
        for s in range(0, feats[0].shape[0], block):
            q = []
            for i, f in enumerate(feats):
                given = None if bit_maps is None else bit_maps[i][s:s + block].to(torch.float32)
                fq, c, b = self.transform(f[s:s + block], i, temperature,
                                          batch_range=ranges[i], bit_map=given)
                q.append(fq)
                cmaps[i].append(c)
                bmaps[i].append(b)
            for i, m in enumerate(self.head(self.neck(*q))):
                raw[i].append(m)
        bmaps = [torch.cat(b) for b in bmaps]
        return {"raw": [torch.cat(r) for r in raw], "feats": feats,
                "complexity": [torch.cat(c) for c in cmaps], "bits": bmaps,
                "avg_bits": torch.stack([b.mean() for b in bmaps]).mean()}


@contextlib.contextmanager
def float32_products(tf32: bool = False):
    """Float32 matrix products and convolutions inside the block: without
    TF32 (the reference) or, `tf32`, with it (the control's float32 math)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
