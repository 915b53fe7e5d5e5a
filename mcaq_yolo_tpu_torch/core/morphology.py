"""
Morphological complexity analysis, per-tile metric mode (eval path).

Port of `mcaq_yolo_tpu/core/morphology.py:304-583` with the operator
arithmetic of its default engine, `core/morphology_lanes.py` (separable
shift-add Gaussian/Sobel, shift-max/min binary morphology, sort-based
per-tile Otsu).  The reference packs tiles into the TPU's 128 vector lanes
as (G, t, t, 128); that packing is a TPU register-layout device, so here
the tiles are a plain batch, (N, t, t) with N = B * ht * wt.

Per tile (Algorithm 1 lines 1-14): phi1 box-counting fractal dimension of
the Canny edges, phi2 uniform-LBP entropy, phi3 gradient variance, phi4
edge density, phi5 Euler-corrected inverse circularity of the adaptive
binarization, plus three interaction terms -> (B, ht, wt, 8).  A small MLP
maps phi to a complexity in [0, 1], which a bilateral filter smooths.

`score_image_eq8` and `MorphologicalComplexityAnalyzer.score_image` are
the deterministic Eq.(8) dataset scores of the curriculum; on a 640 px
image at grid 8 they run the same engine on a 10 x 10 grid of 64 x 64
tiles (the tile is the largest power of two <= 640 / 8).

Not ported here: the 'global' metric mode and the legacy Canny / Otsu
binarization variants (ROADMAP queue A).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import initializers as init
from . import image_ops as iops

# ---------------------------------------------------------------------------
# Intra-tile shifts on (N, t, t)
# ---------------------------------------------------------------------------


def _pad(x: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """Pad the tile border by p: 'edge' replicates (cv2 reflect101
    approximation), 'zero' pads 0 (dilation), 'one' pads 1 (erosion)."""
    if mode == "edge":
        return F.pad(x[:, None], (p, p, p, p), mode="replicate")[:, 0]
    return F.pad(x, (p, p, p, p), value=1.0 if mode == "one" else 0.0)


def _shifted(xp: torch.Tensor, p: int, t: int, dy: int, dx: int) -> torch.Tensor:
    """Tile content shifted by (dy, dx) — out[y, x] = x[y + dy, x + dx] —
    read from a tensor padded by p >= max(|dy|, |dx|)."""
    return xp[:, p + dy:p + dy + t, p + dx:p + dx + t]


def _shift(x: torch.Tensor, dy: int, dx: int, mode: str) -> torch.Tensor:
    p = max(abs(dy), abs(dx))
    if p == 0:
        return x
    return _shifted(_pad(x, p, mode), p, x.shape[1], dy, dx)


def _sep_filter(x: torch.Tensor, taps, mode: str) -> torch.Tensor:
    """Separable filter: 1-D taps along y then x, accumulated in tap order
    (the reference engine's summation order)."""
    r = len(taps) // 2
    t = x.shape[1]
    xp = _pad(x, r, mode)
    out = None
    for i, w in enumerate(taps):
        s = _shifted(xp, r, t, i - r, 0) * w
        out = s if out is None else out + s
    op = _pad(out, r, mode)
    res = None
    for i, w in enumerate(taps):
        s = _shifted(op, r, t, 0, i - r) * w
        res = s if res is None else res + s
    return res


@functools.lru_cache(maxsize=None)
def _gaussian_taps(k: int, sigma: float):
    """The normalized float32 Gaussian taps as Python floats, computed once
    per (k, sigma): the two the metrics use are computed at import (below
    `adaptive_binarize`), so a forward traced by torch.export finds them as
    constants."""
    g = torch.exp(-(torch.arange(k, dtype=torch.float32) - k // 2) ** 2
                  / (2 * sigma ** 2))
    g = g / g.sum()
    return tuple(float(v) for v in g)


def sobel(x: torch.Tensor):
    """3x3 Sobel via separable passes with edge borders: Gx = [1,2,1]_y *
    [-1,0,1]_x, Gy = [1,2,1]_x * [-1,0,1]_y."""
    t = x.shape[1]

    def pass1(v, taps, axis):
        vp = _pad(v, 1, "edge")
        out = None
        for i, w in enumerate(taps):
            dy, dx = (i - 1, 0) if axis == 0 else (0, i - 1)
            s = _shifted(vp, 1, t, dy, dx) * w
            out = s if out is None else out + s
        return out

    gx = pass1(pass1(x, (1.0, 2.0, 1.0), 0), (-1.0, 0.0, 1.0), 1)
    gy = pass1(pass1(x, (1.0, 2.0, 1.0), 1), (-1.0, 0.0, 1.0), 0)
    return gx, gy


def dilate3(x: torch.Tensor) -> torch.Tensor:
    """3x3 binary dilation: separable shift-max, zero border."""
    m = torch.maximum(torch.maximum(_shift(x, -1, 0, "zero"), x), _shift(x, 1, 0, "zero"))
    return torch.maximum(torch.maximum(_shift(m, 0, -1, "zero"), m), _shift(m, 0, 1, "zero"))


def erode3(x: torch.Tensor) -> torch.Tensor:
    """3x3 binary erosion: separable shift-min, pad-one border (outside the
    tile never wins the min)."""
    m = torch.minimum(torch.minimum(_shift(x, -1, 0, "one"), x), _shift(x, 1, 0, "one"))
    return torch.minimum(torch.minimum(_shift(m, 0, -1, "one"), m), _shift(m, 0, 1, "one"))


# ---------------------------------------------------------------------------
# Per-tile Otsu, Canny, binarization
# ---------------------------------------------------------------------------


def otsu_threshold(x: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Per-tile Otsu of (N, t, t) in [0, 1] -> (N, 1, 1).

    The 256-bin histogram argmax evaluated by sorting the tile's bin
    indices and scoring sigma_b only at the last pixel of each value run
    (reference `morphology_lanes.py:178-212`; ties go to the smallest bin)."""
    N, t, _ = x.shape
    n = t * t
    idx = torch.clamp((x * bins).to(torch.int32), 0, bins - 1)
    v = torch.sort(idx.reshape(N, n), dim=1).values
    centers = (v.to(torch.float32) + 0.5) / bins

    p = 1.0 / n
    omega = (torch.arange(1, n + 1, dtype=torch.float32, device=x.device) * p)[None]
    mu = torch.cumsum(centers * p, dim=1)
    mu_t = mu[:, -1:]
    sigma_b = (mu_t * omega - mu) ** 2 / (omega * (1.0 - omega) + 1e-12)

    is_boundary = torch.cat(
        [v[:, :-1] != v[:, 1:], torch.ones((N, 1), dtype=torch.bool, device=x.device)],
        dim=1)
    sigma_b = torch.where(is_boundary, sigma_b, torch.full_like(sigma_b, -1.0))
    best = torch.argmax(sigma_b, dim=1, keepdim=True)
    thr_bin = torch.gather(v, 1, best)
    return ((thr_bin.to(torch.float32) + 0.5) / bins)[:, :, None]


def _canny_nms(mag, gx, gy):
    """Non-maximum suppression along 4 quantized gradient directions."""
    angle = torch.atan2(gy, gx) * (180.0 / math.pi)
    angle = torch.where(angle < 0, angle + 180.0, angle)
    t = mag.shape[1]
    mp = _pad(mag, 1, "edge")

    def sh(dy, dx):
        return _shifted(mp, 1, t, dy, dx)

    bins = [
        ((angle < 22.5) | (angle >= 157.5), (0, 1), (0, -1)),
        ((angle >= 22.5) & (angle < 67.5), (-1, 1), (1, -1)),
        ((angle >= 67.5) & (angle < 112.5), (-1, 0), (1, 0)),
        ((angle >= 112.5) & (angle < 157.5), (-1, -1), (1, 1)),
    ]
    nms = torch.zeros_like(mag)
    for sel, (dy1, dx1), (dy2, dx2) in bins:
        keep = (mag >= sh(dy1, dx1)) & (mag >= sh(dy2, dx2))
        nms = torch.where(sel & keep, mag, nms)
    return nms


def canny_cv2compat(tiles: torch.Tensor, hysteresis_iters: int = 8) -> torch.Tensor:
    """Per-tile Canny with cv2's operator semantics: 0..255 domain, 5x5
    Gaussian sigma 1, Otsu on the blurred intensity (high = Otsu, low =
    Otsu / 2), L1 magnitude, 4-direction NMS, fixed-count dilation
    hysteresis.  (N, t, t) in [0, 1] -> {0, 1}."""
    b01 = _sep_filter(tiles, _gaussian_taps(5, 1.0), "edge")
    b255 = b01 * 255.0
    thr255 = otsu_threshold(b01) * 255.0

    gx, gy = sobel(b255)
    mag = torch.abs(gx) + torch.abs(gy)
    nms = _canny_nms(mag, gx, gy)
    strong = (nms > thr255).to(tiles.dtype)
    weak = nms > 0.5 * thr255

    edge = strong
    for _ in range(max(1, hysteresis_iters)):
        grown = dilate3(edge)
        edge = torch.where(weak & (grown > 0), torch.ones_like(edge), edge)
    return edge


def adaptive_binarize(tiles: torch.Tensor, block: int = 11, C: float = 2.0) -> torch.Tensor:
    """cv2.adaptiveThreshold(GAUSSIAN, BINARY, 11, 2) per tile:
    1 iff src > G11(src) - C in 0..255 units."""
    g255 = tiles * 255.0
    sigma = 0.3 * ((block - 1) * 0.5 - 1) + 0.8
    local_mean = _sep_filter(g255, _gaussian_taps(block, sigma), "edge")
    return (g255 > local_mean - C).to(tiles.dtype)


_gaussian_taps(5, 1.0)                             # cv2compat Canny's blur
_gaussian_taps(11, 0.3 * ((11 - 1) * 0.5 - 1) + 0.8)  # adaptive_binarize's default


# ---------------------------------------------------------------------------
# phi metrics: (N, t, t) -> (N,)
# ---------------------------------------------------------------------------


def fractal_dimension(edge: torch.Tensor, tile: int) -> torch.Tensor:
    """phi1 core: weighted log-log slope of dyadic box counts (scales
    2..tile, weights e^{-0.1 i}), clipped to [1, 2]."""
    scales = []
    s = 2
    while s <= tile:
        scales.append(s)
        s *= 2
    if len(scales) < 2:
        return torch.ones(edge.shape[0], dtype=torch.float32, device=edge.device)
    # box occupancy at scale s is the max over each s x s block (exact
    # for {0, 1} maps; equals the reference's dyadic shift-max coarsening)
    n = torch.stack([F.max_pool2d(edge[:, None], s).sum(dim=(1, 2, 3))
                     for s in scales], dim=0)  # (S, N)
    S = len(scales)
    dev = edge.device
    x = torch.log(torch.tensor(scales, dtype=torch.float32, device=dev)).reshape(S, 1)
    y = torch.log(n + 1.0)
    w = torch.exp(-0.1 * torch.arange(S, dtype=torch.float32, device=dev)).reshape(S, 1)
    w_sum = w.sum(dim=0)
    x_mean = (w * x).sum(dim=0) / w_sum
    y_mean = (w * y).sum(dim=0) / w_sum
    cov = (w * (x - x_mean) * (y - y_mean)).sum(dim=0)
    var = (w * (x - x_mean) ** 2).sum(dim=0)
    return torch.clamp(-(cov / (var + 1e-12)), 1.0, 2.0)


_LBP_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)]


def lbp_entropy(tiles: torch.Tensor) -> torch.Tensor:
    """phi2: uniform-LBP (P=8, R=1) 10-bin histogram entropy / log2(10);
    neighbour reads replicate the tile border."""
    t = tiles.shape[1]
    tp = _pad(tiles, 1, "edge")
    bits = [(_shifted(tp, 1, t, dy, dx) >= tiles).to(torch.float32)
            for dy, dx in _LBP_OFFSETS]
    n_ones = sum(bits)
    trans = sum(torch.abs(bits[i] - bits[i - 1]) for i in range(8))
    label = torch.where(trans <= 2.0, n_ones, torch.full_like(n_ones, 9.0))

    n = t * t
    ent = torch.zeros(tiles.shape[0], dtype=torch.float32, device=tiles.device)
    for v in range(10):
        p = (label == v).to(torch.float32).sum(dim=(1, 2)) / n
        ent = ent - p * torch.log2(p + 1e-10)
    return ent / math.log2(10.0)


def gradient_variance(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """phi3: Eq.(22) v / (v + 1), v = Var(Gx) + Var(Gy) over the tile."""

    def var(t):
        m = t.mean(dim=(1, 2))
        m2 = (t * t).mean(dim=(1, 2))
        return torch.clamp(m2 - m * m, min=0.0)

    v = var(gx) + var(gy)
    return v / (v + 1.0)


def euler_components(m: torch.Tensor) -> torch.Tensor:
    """8-connected component count per tile via Gray's quad-pattern Euler
    number over all (t+1)^2 windows of the zero-padded mask, K >= 1."""
    mp = F.pad(m, (1, 1, 1, 1))
    idx = (mp[:, :-1, :-1] + 2.0 * mp[:, :-1, 1:] + 4.0 * mp[:, 1:, :-1]
           + 8.0 * mp[:, 1:, 1:]).to(torch.int32)

    def count(vals):
        acc = torch.zeros(idx.shape, dtype=torch.float32, device=m.device)
        for v in vals:
            acc = acc + (idx == v).to(torch.float32)
        return acc.sum(dim=(1, 2))

    e = (count([1, 2, 4, 8]) - count([7, 11, 13, 14]) - 2.0 * count([6, 9])) / 4.0
    return torch.clamp(torch.round(e), min=1.0)


def contour_complexity(binmask: torch.Tensor) -> torch.Tensor:
    """phi5: Eq.(24) 1 - 1/max(perim^2 / (4 pi area) / K, 1); empty tiles 0."""
    boundary = torch.clamp(binmask - erode3(binmask), min=0.0)
    area = binmask.sum(dim=(1, 2))
    perim = boundary.sum(dim=(1, 2))
    ic = (perim * perim) / (4.0 * math.pi * area + 1e-6)
    ic = ic / euler_components(binmask)
    phi5 = 1.0 - 1.0 / torch.clamp(ic, min=1.0)
    return torch.where(area > 0, phi5, torch.zeros_like(phi5))


def extract_tiles(gray: torch.Tensor, tile: int):
    """(B, Hc, Wc) -> (B*ht*wt, tile, tile): tiles as a plain batch."""
    B, Hc, Wc = gray.shape
    ht, wt = Hc // tile, Wc // tile
    t = gray.reshape(B, ht, tile, wt, tile).permute(0, 1, 3, 2, 4)
    return t.reshape(B * ht * wt, tile, tile), ht, wt


def phi_metrics_tiled(gray: torch.Tensor, tile: int):
    """gray (B, Hc, Wc) -> five (B, ht, wt) metric maps (phi1 unhalved)."""
    B = gray.shape[0]
    tiles, ht, wt = extract_tiles(gray, tile)
    gx, gy = sobel(tiles)
    edge = canny_cv2compat(tiles)
    binmask = adaptive_binarize(tiles)

    def out(v):
        return v.reshape(B, ht, wt)

    return (out(fractal_dimension(edge, tile)), out(lbp_entropy(tiles)),
            out(gradient_variance(gx, gy)), out(edge.mean(dim=(1, 2))),
            out(contour_complexity(binmask)))


def compute_phi_tiles(
    features: torch.Tensor, grid_size: int = 8, downsample: int = 1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """features (B, H, W, C) NHWC (or a (B, H, W, 3) image) ->
    (phi (B, ht, wt, 8), dict of the five raw metrics).  Always float32.

    downsample: run the metric operators on a 2^k average-pooled gray map;
    the factor degrades per scale so tile/downsample stays >= 4
    (reference `morphology.py:358-374`)."""
    with torch.no_grad():
        if not features.is_floating_point():
            features = features.to(torch.float32) / 255.0
        B, H, W, C = features.shape
        tile = iops.tile_size_for(H, grid_size)
        ht, wt = H // tile, W // tile
        Hc, Wc = ht * tile, wt * tile

        gray = torch.mean(features[:, :Hc, :Wc, :], dim=-1, dtype=torch.float32)
        if downsample > 1:
            if downsample & (downsample - 1):
                raise ValueError(
                    f"morph_downsample must be a power of two, got {downsample}")
            ds = downsample
            while ds > 1 and tile // ds < 4:
                ds //= 2
            if ds > 1:
                gray = iops.avg_pool(gray, ds)
                tile //= ds
        gray = iops.normalize01(gray)

        phi1, phi2, phi3, phi4, phi5 = phi_metrics_tiled(gray, tile)
        phi1 = phi1 / 2.0
        phi = torch.stack(
            [phi1, phi2, phi3, phi4, phi5,
             phi1 * phi2, phi3 ** 2, torch.sqrt(phi4 * phi5 + 1e-12)], dim=-1)
        detailed = {"fractal": phi1, "texture": phi2, "gradient": phi3,
                    "edge": phi4, "contour": phi5}
    return phi, detailed


def _eq8(phi: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """C = sum_i |alpha_i| phi_i / sum |alpha|, tile-averaged, in [0, 1]."""
    a = torch.abs(alpha.to(torch.float32))
    a = a / torch.clamp(a.sum(), min=1e-8)
    c = (phi[..., :5] * a.reshape(1, 1, 1, 5)).sum(dim=-1)
    return torch.clamp(c.mean(dim=(1, 2)), 0.0, 1.0)


def score_image_eq8(images: torch.Tensor, grid_size: int = 8,
                    alpha=None) -> torch.Tensor:
    """Model-free Eq.(8) per-image complexity (Algorithm 3 line 1;
    reference `morphology.py:446-466`): phi of the whole image (no
    downsampling), weighted by `alpha` (default the uniform initial
    weights).  images (B, H, W, 3) uint8 or float -> (B,) in [0, 1]."""
    phi, _ = compute_phi_tiles(images, grid_size=grid_size)
    if alpha is None:
        alpha = torch.full((5,), 0.2, device=phi.device)
    return _eq8(phi, torch.as_tensor(alpha, device=phi.device))


# ---------------------------------------------------------------------------
# Bilateral filter, complexity MLP, analyzer
# ---------------------------------------------------------------------------


def bilateral_filter(c_map: torch.Tensor, sigma_spatial: float = 2.0,
                     sigma_range: float = 0.1, kernel_size: int = 5) -> torch.Tensor:
    """Bilateral filter of a (B, ht, wt) complexity map with replicate
    padding (reference `morphology.py:474-501`)."""
    B, H, W = c_map.shape
    pad = kernel_size // 2
    xp = iops.replicate_pad(c_map, pad)
    patches = torch.stack(
        [xp[:, pad + dy:pad + dy + H, pad + dx:pad + dx + W]
         for dy in range(-pad, pad + 1) for dx in range(-pad, pad + 1)], dim=-1)
    sw = torch.tensor(iops.spatial_weights(kernel_size, sigma_spatial),
                      dtype=torch.float32, device=c_map.device)
    range_w = torch.exp(-((patches - c_map[..., None]) ** 2) / (2.0 * sigma_range ** 2))
    weights = sw * range_w
    return (weights * patches).sum(dim=-1) / (weights.sum(dim=-1) + 1e-8)


class ComplexityMLP(nn.Module):
    """8 -> 64 -> 32 -> 1 LayerNorm(eps 1e-5) + ReLU MLP, sigmoid head."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(8, 64)
        self.LayerNorm_0 = nn.LayerNorm(64, eps=1e-5)
        self.Dense_1 = nn.Linear(64, 32)
        self.LayerNorm_1 = nn.LayerNorm(32, eps=1e-5)
        self.Dense_2 = nn.Linear(32, 1)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator):
        for d in (self.Dense_0, self.Dense_1):
            init.lecun_normal_(d.weight, g)
            d.bias.zero_()
        init.xavier_uniform_(self.Dense_2.weight, 3.0, g)
        self.Dense_2.bias.zero_()
        for ln in (self.LayerNorm_0, self.LayerNorm_1):
            ln.reset_parameters()

    def forward(self, phi: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.LayerNorm_0(self.Dense_0(phi)))
        x = F.relu(self.LayerNorm_1(self.Dense_1(x)))
        return torch.sigmoid(self.Dense_2(x))


class MorphologicalComplexityAnalyzer(nn.Module):
    """features NHWC -> complexity (B, ht, wt) in [0, 1]: phi (no grad) ->
    ComplexityMLP -> bilateral filter (sigma_s 2, sigma_r 0.1) -> clip.

    `feature_weights` is the Eq.(8) weights buffer of the deterministic
    dataset score (`score_image`), refit to the trained MLP by the
    curriculum (`morphology_cv2.fit_feature_weights`); the inference path
    does not read it."""

    def __init__(self, grid_size: int = 8, downsample: int = 1):
        super().__init__()
        self.grid_size = grid_size
        self.downsample = downsample
        self.complexity_mlp = ComplexityMLP()
        self.register_buffer("feature_weights", torch.full((5,), 0.2))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        phi, _ = compute_phi_tiles(features, self.grid_size, self.downsample)
        B, ht, wt, _ = phi.shape
        c = self.complexity_mlp(phi.reshape(-1, 8)).reshape(B, ht, wt)
        return torch.clamp(bilateral_filter(c), 0.0, 1.0)

    def score_image(self, features: torch.Tensor) -> torch.Tensor:
        """Deterministic Eq.(8) per-image complexity for dataset sorting
        (Algorithm 3 line 1) with this analyzer's phi and `feature_weights`:
        (B,) in [0, 1]."""
        phi, _ = compute_phi_tiles(features, self.grid_size, self.downsample)
        return _eq8(phi, self.feature_weights)
