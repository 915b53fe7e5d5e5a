"""
Morphological complexity analysis (port of `mcaq_yolo_tpu/core/morphology.py`).

The per-tile metric mode (the default, and the deployed path) runs the operator
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

The options kept for ablation, with the reference's defaults: `canny_impl=
'legacy'` (L2 magnitude, Otsu on the normalized NMS, 2 hysteresis passes),
`binarize_impl='otsu'`, `contour_components=False` (no Euler-K division) and
`metric_mode='global'` (the reference surrogate's whole-image operators
with zero borders, then per-tile statistics; `phi_metrics_global`).  The
shift operators below take (N, t, t) tiles or whole (B, H, W) maps alike;
the global mode's blurs and Sobel are the reference's whole-image convs
(`image_ops`).
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
# Shifts within a map: (N, t, t) tiles or whole (B, H, W) images
# ---------------------------------------------------------------------------


def _pad(x: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """Pad the map's border by p: 'edge' replicates (cv2 reflect101
    approximation), 'zero' pads 0 (dilation), 'one' pads 1 (erosion)."""
    if mode == "edge":
        return F.pad(x[:, None], (p, p, p, p), mode="replicate")[:, 0]
    return F.pad(x, (p, p, p, p), value=1.0 if mode == "one" else 0.0)


def _shifted(xp: torch.Tensor, p: int, dy: int, dx: int) -> torch.Tensor:
    """Map content shifted by (dy, dx) — out[y, x] = x[y + dy, x + dx] —
    read from a map padded by p >= max(|dy|, |dx|)."""
    H, W = xp.shape[1] - 2 * p, xp.shape[2] - 2 * p
    return xp[:, p + dy:p + dy + H, p + dx:p + dx + W]


def _shift(x: torch.Tensor, dy: int, dx: int, mode: str) -> torch.Tensor:
    p = max(abs(dy), abs(dx))
    if p == 0:
        return x
    return _shifted(_pad(x, p, mode), p, dy, dx)


def _sep_filter(x: torch.Tensor, taps, mode: str) -> torch.Tensor:
    """Separable filter: 1-D taps along y then x, accumulated in tap order
    (the reference engine's summation order)."""
    r = len(taps) // 2
    xp = _pad(x, r, mode)
    out = None
    for i, w in enumerate(taps):
        s = _shifted(xp, r, i - r, 0) * w
        out = s if out is None else out + s
    op = _pad(out, r, mode)
    res = None
    for i, w in enumerate(taps):
        s = _shifted(op, r, 0, i - r) * w
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


def sobel(x: torch.Tensor, mode: str = "edge"):
    """3x3 Sobel via separable passes, tile borders `mode` ('edge' or
    'zero'): Gx = [1,2,1]_y * [-1,0,1]_x, Gy = [1,2,1]_x * [-1,0,1]_y."""

    def pass1(v, taps, axis):
        vp = _pad(v, 1, mode)
        out = None
        for i, w in enumerate(taps):
            dy, dx = (i - 1, 0) if axis == 0 else (0, i - 1)
            s = _shifted(vp, 1, dy, dx) * w
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
    """Non-maximum suppression along 4 quantized gradient directions, the
    neighbours read with edge borders.  Tiles (N, t, t) or whole (B, H, W)
    maps."""
    angle = torch.atan2(gy, gx) * (180.0 / math.pi)
    angle = torch.where(angle < 0, angle + 180.0, angle)
    mp = _pad(mag, 1, "edge")

    def sh(dy, dx):
        return _shifted(mp, 1, dy, dx)

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
    return _hysteresis((nms > thr255).to(tiles.dtype), nms > 0.5 * thr255,
                       max(1, hysteresis_iters))


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` dilation passes growing the strong edges into the weak ones."""
    edge = strong
    for _ in range(iters):
        grown = dilate3(edge)
        edge = torch.where(weak & (grown > 0), torch.ones_like(edge), edge)
    return edge


def canny_legacy(tiles: torch.Tensor) -> torch.Tensor:
    """The legacy per-tile surrogate (reference `morphology_lanes.py:399-414`):
    zero-border blur and Sobel, L2 magnitude, Otsu on the tile's min-max
    normalized NMS (high = Otsu, low = Otsu / 2), 2 hysteresis passes."""
    b = _sep_filter(tiles, _gaussian_taps(5, 1.0), "zero")
    gx, gy = sobel(b, mode="zero")
    mag = torch.sqrt(gx ** 2 + gy ** 2 + 1e-12)
    nms = _canny_nms(mag, gx, gy)
    mn = nms.amin(dim=(1, 2), keepdim=True)
    mx = nms.amax(dim=(1, 2), keepdim=True)
    nms_n = (nms - mn) / (mx - mn + 1e-8)
    thr = otsu_threshold(nms_n)
    return _hysteresis((nms_n > thr).to(tiles.dtype), nms_n > 0.5 * thr, 2)


def adaptive_binarize(tiles: torch.Tensor, block: int = 11, C: float = 2.0) -> torch.Tensor:
    """cv2.adaptiveThreshold(GAUSSIAN, BINARY, 11, 2) per tile:
    1 iff src > G11(src) - C in 0..255 units."""
    g255 = tiles * 255.0
    sigma = 0.3 * ((block - 1) * 0.5 - 1) + 0.8
    local_mean = _sep_filter(g255, _gaussian_taps(block, sigma), "edge")
    return (g255 > local_mean - C).to(tiles.dtype)


def otsu_binarize(tiles: torch.Tensor) -> torch.Tensor:
    """The legacy binarization: 1 above the tile's own Otsu threshold."""
    return (tiles > otsu_threshold(tiles)).to(tiles.dtype)


_gaussian_taps(5, 1.0)                             # cv2compat Canny's blur
_gaussian_taps(11, 0.3 * ((11 - 1) * 0.5 - 1) + 0.8)  # adaptive_binarize's default


# ---------------------------------------------------------------------------
# phi metrics: (N, t, t) -> (N,)
# ---------------------------------------------------------------------------


def _dyadic_scales(tile: int):
    scales, s = [], 2
    while s <= tile:
        scales.append(s)
        s *= 2
    return scales


def _fractal_slope(n: torch.Tensor, scales) -> torch.Tensor:
    """Box counts n (S, ...) at the dyadic `scales` -> the weighted log-log
    slope (weights e^{-0.1 i}) over the first axis, clipped to [1, 2]."""
    S = len(scales)
    shape = (S,) + (1,) * (n.dim() - 1)
    dev = n.device
    # the scales 2, 4, ... made on the device (no copy from the host, which
    # would synchronize with it): exact integers, as float32 as listed
    s = 2 ** torch.arange(1, S + 1, device=dev)
    x = torch.log(s.to(torch.float32)).reshape(shape)
    y = torch.log(n + 1.0)
    w = torch.exp(-0.1 * torch.arange(S, dtype=torch.float32, device=dev)).reshape(shape)
    w_sum = w.sum(dim=0)
    x_mean = (w * x).sum(dim=0) / w_sum
    y_mean = (w * y).sum(dim=0) / w_sum
    cov = (w * (x - x_mean) * (y - y_mean)).sum(dim=0)
    var = (w * (x - x_mean) ** 2).sum(dim=0)
    return torch.clamp(-(cov / (var + 1e-12)), 1.0, 2.0)


def fractal_dimension(edge: torch.Tensor, tile: int) -> torch.Tensor:
    """phi1 core: weighted log-log slope of dyadic box counts (scales
    2..tile, weights e^{-0.1 i}), clipped to [1, 2]."""
    scales = _dyadic_scales(tile)
    if len(scales) < 2:
        return torch.ones(edge.shape[0], dtype=torch.float32, device=edge.device)
    # box occupancy at scale s is the max over each s x s block (exact
    # for {0, 1} maps; equals the reference's dyadic shift-max coarsening)
    n = torch.stack([F.max_pool2d(edge[:, None], s).sum(dim=(1, 2, 3))
                     for s in scales], dim=0)  # (S, N)
    return _fractal_slope(n, scales)


_LBP_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)]


def _lbp_labels(x: torch.Tensor) -> torch.Tensor:
    """Uniform-LBP (P=8, R=1) labels of (B, H, W): the number of neighbours
    >= the pixel for patterns with at most 2 circular transitions, else 9;
    neighbours past the border replicate it."""
    xp = _pad(x, 1, "edge")
    bits = [(_shifted(xp, 1, dy, dx) >= x).to(torch.float32) for dy, dx in _LBP_OFFSETS]
    n_ones = sum(bits)
    trans = sum(torch.abs(bits[i] - bits[i - 1]) for i in range(8))
    return torch.where(trans <= 2.0, n_ones, torch.full_like(n_ones, 9.0))


def _entropy10(label: torch.Tensor, tile_mean) -> torch.Tensor:
    """Entropy of the 10-bin label histogram per tile / log2(10);
    `tile_mean` takes a {0, 1} map to its per-tile means."""
    ent = None
    for v in range(10):
        p = tile_mean((label == v).to(torch.float32))
        term = p * torch.log2(p + 1e-10)
        ent = -term if ent is None else ent - term
    return ent / math.log2(10.0)


def lbp_entropy(tiles: torch.Tensor) -> torch.Tensor:
    """phi2: uniform-LBP (P=8, R=1) 10-bin histogram entropy / log2(10);
    neighbour reads replicate the tile border."""
    n = tiles.shape[1] * tiles.shape[2]
    return _entropy10(_lbp_labels(tiles), lambda m: m.sum(dim=(1, 2)) / n)


def _gradient_variance(gx: torch.Tensor, gy: torch.Tensor, tile_mean) -> torch.Tensor:
    """Eq.(22) v / (v + 1), v = Var(Gx) + Var(Gy) with `tile_mean`."""

    def var(t):
        m = tile_mean(t)
        return torch.clamp(tile_mean(t * t) - m * m, min=0.0)

    v = var(gx) + var(gy)
    return v / (v + 1.0)


def gradient_variance(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """phi3: Eq.(22) v / (v + 1), v = Var(Gx) + Var(Gy) over the tile."""
    return _gradient_variance(gx, gy, lambda t: t.mean(dim=(1, 2)))


def _euler_windows(m: torch.Tensor) -> torch.Tensor:
    """Gray's quad-pattern Euler contribution (Q1 - Q3 - 2 QD) / 4 of each
    2x2 window of the zero-padded mask (B, H, W) -> (B, H + 1, W + 1)."""
    mp = F.pad(m, (1, 1, 1, 1))
    idx = (mp[:, :-1, :-1] + 2.0 * mp[:, :-1, 1:] + 4.0 * mp[:, 1:, :-1]
           + 8.0 * mp[:, 1:, 1:]).to(torch.int32)

    def count(vals):
        acc = torch.zeros(idx.shape, dtype=torch.float32, device=m.device)
        for v in vals:
            acc = acc + (idx == v).to(torch.float32)
        return acc

    return (count([1, 2, 4, 8]) - count([7, 11, 13, 14]) - 2.0 * count([6, 9])) / 4.0


def euler_components(m: torch.Tensor) -> torch.Tensor:
    """8-connected component count per tile via Gray's quad-pattern Euler
    number over all (t+1)^2 windows of the zero-padded mask, K >= 1."""
    return torch.clamp(torch.round(_euler_windows(m).sum(dim=(1, 2))), min=1.0)


def _phi5(area: torch.Tensor, perim: torch.Tensor, K) -> torch.Tensor:
    """Eq.(24) 1 - 1/max(perim^2 / (4 pi area) / K, 1) (K None: 1); 0 where
    the tile is empty."""
    ic = (perim * perim) / (4.0 * math.pi * area + 1e-6)
    if K is not None:
        ic = ic / K
    phi5 = 1.0 - 1.0 / torch.clamp(ic, min=1.0)
    return torch.where(area > 0, phi5, torch.zeros_like(phi5))


def contour_complexity(binmask: torch.Tensor, contour_components: bool = True) -> torch.Tensor:
    """phi5: Eq.(24) 1 - 1/max(perim^2 / (4 pi area) / K, 1), K = 1 without
    `contour_components`; empty tiles 0."""
    boundary = torch.clamp(binmask - erode3(binmask), min=0.0)
    K = euler_components(binmask) if contour_components else None
    return _phi5(binmask.sum(dim=(1, 2)), boundary.sum(dim=(1, 2)), K)


def extract_tiles(gray: torch.Tensor, tile: int):
    """(B, Hc, Wc) -> (B*ht*wt, tile, tile): tiles as a plain batch."""
    B, Hc, Wc = gray.shape
    ht, wt = Hc // tile, Wc // tile
    t = gray.reshape(B, ht, tile, wt, tile).permute(0, 1, 3, 2, 4)
    return t.reshape(B * ht * wt, tile, tile), ht, wt


def phi_metrics_tiled(gray: torch.Tensor, tile: int, canny_impl: str = "cv2compat",
                      binarize_impl: str = "adaptive", contour_components: bool = True):
    """gray (B, Hc, Wc) -> five (B, ht, wt) metric maps (phi1 unhalved),
    every operator per tile (reference `morphology_lanes.py:395-434`)."""
    B = gray.shape[0]
    tiles, ht, wt = extract_tiles(gray, tile)
    gx, gy = sobel(tiles)
    edge = canny_legacy(tiles) if canny_impl == "legacy" else canny_cv2compat(tiles)
    binmask = otsu_binarize(tiles) if binarize_impl == "otsu" else adaptive_binarize(tiles)

    def out(v):
        return v.reshape(B, ht, wt)

    return (out(fractal_dimension(edge, tile)), out(lbp_entropy(tiles)),
            out(gradient_variance(gx, gy)), out(edge.mean(dim=(1, 2))),
            out(contour_complexity(binmask, contour_components)))


# ---------------------------------------------------------------------------
# metric_mode='global': whole-image operators, per-tile statistics
# (reference `morphology.py:41-291`, the row engine's functions)
# ---------------------------------------------------------------------------


def canny_cv2compat_image(gray: torch.Tensor, hysteresis_iters: int = 8) -> torch.Tensor:
    """`canny_cv2compat` over whole (B, H, W) images with zero borders and
    one Otsu threshold per image."""
    b01 = iops.gaussian_blur(gray, 5, 1.0, mode="zero")
    b255 = b01 * 255.0
    thr255 = iops.otsu_threshold(b01) * 255.0
    gx, gy = iops.sobel(b255, mode="zero")
    nms = _canny_nms(torch.abs(gx) + torch.abs(gy), gx, gy)
    return _hysteresis((nms > thr255).to(torch.float32), nms > 0.5 * thr255,
                       max(1, hysteresis_iters))


def canny_legacy_image(gray: torch.Tensor) -> torch.Tensor:
    """`canny_legacy` over whole images: zero borders, L2 magnitude, Otsu
    on the image's min-max normalized NMS, 2 hysteresis passes."""
    blurred = iops.gaussian_blur(gray, 5, 1.0, mode="zero")
    gx, gy = iops.sobel(blurred)
    nms = _canny_nms(torch.sqrt(gx ** 2 + gy ** 2 + 1e-12), gx, gy)
    nms_n = iops.normalize01(nms)
    thr = iops.otsu_threshold(nms_n)
    return _hysteresis((nms_n > thr).to(torch.float32), nms_n > 0.5 * thr, 2)


def adaptive_binarize_image(gray: torch.Tensor, block: int = 11, C: float = 2.0) -> torch.Tensor:
    """`adaptive_binarize` over whole images (the 11 x 11 Gaussian as one
    replicate-padded conv)."""
    g255 = gray * 255.0
    sigma = 0.3 * ((block - 1) * 0.5 - 1) + 0.8
    local_mean = iops.gaussian_blur(g255, block, sigma, mode="edge")
    return (g255 > local_mean - C).to(torch.float32)


def otsu_binarize_image(gray: torch.Tensor) -> torch.Tensor:
    """1 above the image's Otsu threshold."""
    return (gray > iops.otsu_threshold(gray)).to(torch.float32)


def fractal_dimension_tiles(edge: torch.Tensor, tile: int) -> torch.Tensor:
    """phi1 core from a whole edge map (B, Hc, Wc) -> (B, ht, wt): occupied
    boxes per tile at each dyadic scale, then the weighted log-log slope."""
    B, Hc, Wc = edge.shape
    scales = _dyadic_scales(tile)
    if len(scales) < 2:
        return torch.ones((B, Hc // tile, Wc // tile), dtype=torch.float32,
                          device=edge.device)
    n = torch.stack([iops.avg_pool(iops.max_pool(edge, s), tile // s) * float((tile // s) ** 2)
                     for s in scales], dim=0)  # (S, B, ht, wt)
    return _fractal_slope(n, scales)


def lbp_entropy_tiles(gray: torch.Tensor, tile: int) -> torch.Tensor:
    """phi2 from a whole map: the uniform-LBP labels read their neighbours
    across tile borders (the image border replicates), then a 10-bin
    histogram entropy per tile."""
    return _entropy10(_lbp_labels(gray), lambda m: iops.avg_pool(m, tile))


def gradient_variance_tiles(gx: torch.Tensor, gy: torch.Tensor, tile: int) -> torch.Tensor:
    """phi3 from whole gradient maps: Eq.(22) per tile."""
    return _gradient_variance(gx, gy, lambda t: iops.avg_pool(t, tile))


def euler_components_tiles(m: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-tile component count K >= 1 from a whole mask: each 2x2 window of
    the zero-padded mask is attributed to the tile of its top-left pixel,
    so the bottom and right window row fall away (the reference
    surrogate's attribution, a documented residual it undercounts with)."""
    B, Hc, Wc = m.shape
    ht, wt = Hc // tile, Wc // tile
    e = _euler_windows(m)[:, :ht * tile, :wt * tile]
    return torch.clamp(torch.round(iops.avg_pool(e, tile) * float(tile * tile)), min=1.0)


def contour_complexity_tiles(binmask: torch.Tensor, tile: int,
                             contour_components: bool = True) -> torch.Tensor:
    """phi5 from a whole mask: Eq.(24) per tile, the boundary eroded across
    tile borders."""
    boundary = torch.clamp(binmask - erode3(binmask), min=0.0)
    K = euler_components_tiles(binmask, tile) if contour_components else None
    return _phi5(iops.avg_pool(binmask, tile) * float(tile * tile),
                 iops.avg_pool(boundary, tile) * float(tile * tile), K)


def phi_metrics_global(gray: torch.Tensor, tile: int, canny_impl: str = "cv2compat",
                       binarize_impl: str = "adaptive", contour_components: bool = True):
    """gray (B, Hc, Wc) -> five (B, ht, wt) metric maps (phi1 unhalved),
    the operators over whole images (reference `morphology.py:410-427`)."""
    gx, gy = iops.sobel(gray)
    edge = canny_legacy_image(gray) if canny_impl == "legacy" else canny_cv2compat_image(gray)
    binmask = (otsu_binarize_image(gray) if binarize_impl == "otsu"
               else adaptive_binarize_image(gray))
    return (fractal_dimension_tiles(edge, tile), lbp_entropy_tiles(gray, tile),
            gradient_variance_tiles(gx, gy, tile), iops.avg_pool(edge, tile),
            contour_complexity_tiles(binmask, tile, contour_components))


CANNY_IMPLS = ("cv2compat", "legacy")
BINARIZE_IMPLS = ("adaptive", "otsu")
METRIC_MODES = ("tiled", "global")


def compute_phi_tiles(
    features: torch.Tensor, grid_size: int = 8, canny_impl: str = "cv2compat",
    binarize_impl: str = "adaptive", contour_components: bool = True,
    metric_mode: str = "tiled", downsample: int = 1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """features (B, H, W, C) NHWC (or a (B, H, W, 3) image) ->
    (phi (B, ht, wt, 8), dict of the five raw metrics).  Always float32.

    canny_impl 'cv2compat' | 'legacy', binarize_impl 'adaptive' | 'otsu',
    contour_components (phi5's Euler-K division) and metric_mode 'tiled' |
    'global' are the reference's options (module docstring).
    downsample: run the metric operators on a 2^k average-pooled gray map;
    the factor degrades per scale so tile/downsample stays >= 4
    (reference `morphology.py:358-374`)."""
    for name, value, allowed in (("canny_impl", canny_impl, CANNY_IMPLS),
                                 ("binarize_impl", binarize_impl, BINARIZE_IMPLS),
                                 ("metric_mode", metric_mode, METRIC_MODES)):
        if value not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
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

        metrics = phi_metrics_tiled if metric_mode == "tiled" else phi_metrics_global
        phi1, phi2, phi3, phi4, phi5 = metrics(gray, tile, canny_impl, binarize_impl,
                                               contour_components)
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

    def __init__(self, grid_size: int = 8, canny_impl: str = "cv2compat",
                 binarize_impl: str = "adaptive", contour_components: bool = True,
                 metric_mode: str = "tiled", downsample: int = 1):
        super().__init__()
        self.grid_size = grid_size
        self.canny_impl, self.binarize_impl = canny_impl, binarize_impl
        self.contour_components, self.metric_mode = contour_components, metric_mode
        self.downsample = downsample
        self.complexity_mlp = ComplexityMLP()
        self.register_buffer("feature_weights", torch.full((5,), 0.2))

    def _phi(self, features: torch.Tensor) -> torch.Tensor:
        return compute_phi_tiles(
            features, grid_size=self.grid_size, canny_impl=self.canny_impl,
            binarize_impl=self.binarize_impl, contour_components=self.contour_components,
            metric_mode=self.metric_mode, downsample=self.downsample)[0]

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        phi = self._phi(features)
        B, ht, wt, _ = phi.shape
        c = self.complexity_mlp(phi.reshape(-1, 8)).reshape(B, ht, wt)
        return torch.clamp(bilateral_filter(c), 0.0, 1.0)

    def score_image(self, features: torch.Tensor) -> torch.Tensor:
        """Deterministic Eq.(8) per-image complexity for dataset sorting
        (Algorithm 3 line 1) with this analyzer's phi and `feature_weights`:
        (B,) in [0, 1]."""
        return _eq8(self._phi(features), self.feature_weights)
