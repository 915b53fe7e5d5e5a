"""
Exact OpenCV metric backend, host-side NumPy / cv2 (a copy of
`mcaq_yolo_tpu/core/morphology_cv2.py`): the per-tile metrics (`:37-148`),
`phi_tiles_cv2` and `score_image_cv2` (`:156-210`, the curriculum's
`score_backend: cv2`), the model-free edge-density score (`:213-225`, both
branches) and the NNLS refit of the Eq.(8) weights (`:233-245`).

The same NumPy and cv2 arithmetic as the reference, so the scores are equal
to its scores bitwise.  Runs once per dataset, on the host.  The uniform LBP
(P=8, R=1) is written out (label = popcount for patterns with at most 2
circular transitions, else P+1), as skimage would compute it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

try:
    import cv2

    HAS_CV2 = True
except ImportError:  # cv2 is optional
    HAS_CV2 = False

from .image_ops import tile_size_for


# ---------------------------------------------------------------------------
# Per-tile metric functions (exact Eq.21-24 recipes)
# ---------------------------------------------------------------------------


def fast_fractal_dimension(edge_map: np.ndarray) -> float:
    """Multi-resolution box counting with exponential scale weights
    (reference morphology.py:110-160).  Returns Df in [1, 2]."""
    h, w = edge_map.shape
    min_dim = min(h, w)
    if min_dim < 4:
        return 1.0

    scales, counts = [], []
    for i in range(1, int(np.log2(min_dim)) + 1):
        s = 2**i
        h_new, w_new = h // s, w // s
        if h_new <= 0 or w_new <= 0:
            continue
        pooled = cv2.resize(
            edge_map.astype(np.float32), (w_new, h_new), interpolation=cv2.INTER_AREA
        )
        n_boxes = float(np.sum(pooled > 0))
        if n_boxes > 0:
            scales.append(s)
            counts.append(n_boxes)

    if len(counts) < 2:
        return 1.0

    log_s = np.log(np.asarray(scales, np.float64))
    log_n = np.log(np.asarray(counts, np.float64) + 1)
    weights = np.exp(-0.1 * np.arange(len(scales)))
    coef = np.polyfit(log_s, log_n, 1, w=weights)[0]
    return float(np.clip(-coef, 1.0, 2.0))


def _uniform_lbp(gray: np.ndarray) -> np.ndarray:
    """Uniform LBP P=8, R=1 (skimage.local_binary_pattern 'uniform'
    semantics): uniform patterns labeled by popcount (0..8), others 9."""
    g = gray.astype(np.float32)
    gp = np.pad(g, 1, mode="edge")
    H, W = g.shape
    offsets = [(-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)]
    bits = np.stack(
        [
            (gp[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W] >= g)
            for dy, dx in offsets
        ],
        axis=-1,
    ).astype(np.int32)
    n_ones = bits.sum(-1)
    trans = np.abs(bits - np.roll(bits, 1, axis=-1)).sum(-1)
    return np.where(trans <= 2, n_ones, 9)


def compute_texture_entropy(tile: np.ndarray) -> float:
    """LBP histogram entropy normalized by log2(10)
    (reference morphology.py:162-193)."""
    gray = tile if tile.ndim == 2 else cv2.cvtColor(tile, cv2.COLOR_BGR2GRAY)
    lbp = _uniform_lbp(gray)
    hist, _ = np.histogram(lbp.ravel(), bins=10, range=(0, 10), density=True)
    hist = hist + 1e-10
    p = hist / hist.sum()
    ent = float(-(p * np.log2(p)).sum())
    return ent / math.log2(10.0)


def compute_gradient_variance(tile: np.ndarray) -> float:
    """Eq.(22): v/(v+1) with 3x3 Sobel on [0,1] input
    (reference morphology.py:195-221)."""
    gray = tile if tile.ndim == 2 else cv2.cvtColor(tile, cv2.COLOR_BGR2GRAY)
    g = gray.astype(np.float32)
    if g.max() > 1.5:
        g = g / 255.0
    gx = cv2.Sobel(g, cv2.CV_32F, 1, 0, ksize=3)
    gy = cv2.Sobel(g, cv2.CV_32F, 0, 1, ksize=3)
    v = float(np.var(gx) + np.var(gy))
    return v / (v + 1.0)


def _otsu_canny(gray_u8: np.ndarray) -> np.ndarray:
    """Gaussian blur (5x5, sigma 1) -> Otsu threshold on the blurred
    intensity -> Canny with (0.5*t, t) (reference morphology.py:238-248)."""
    blurred = cv2.GaussianBlur(gray_u8, (5, 5), 1.0)
    otsu_thr, _ = cv2.threshold(blurred, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    return cv2.Canny(blurred, int(max(0, 0.5 * otsu_thr)), int(max(1, otsu_thr)))


def compute_edge_density(tile: np.ndarray) -> float:
    """Eq.(23): fraction of Canny edge pixels (reference morphology.py:223-251)."""
    gray = tile if tile.ndim == 2 else cv2.cvtColor(tile, cv2.COLOR_BGR2GRAY)
    edges = _otsu_canny(gray)
    return float(np.sum(edges > 0) / edges.size)


def compute_contour_complexity(tile: np.ndarray) -> float:
    """Eq.(24): mean inverse circularity of external contours, mapped to
    [0,1) via 1 - 1/ic (reference morphology.py:253-307)."""
    gray = tile if tile.ndim == 2 else cv2.cvtColor(tile, cv2.COLOR_BGR2GRAY)
    binary = cv2.adaptiveThreshold(
        gray, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, 11, 2
    )
    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return 0.0
    ics = []
    for c in contours:
        area = cv2.contourArea(c)
        if area > 10:
            perim = cv2.arcLength(c, True)
            if perim > 0:
                ics.append(float(perim**2 / (4.0 * math.pi * area)))
    if not ics:
        return 0.0
    ic_mean = max(float(np.mean(ics)), 1.0)
    return 1.0 - 1.0 / ic_mean


# ---------------------------------------------------------------------------
# Full per-tile phi computation
# ---------------------------------------------------------------------------


def phi_tiles_cv2(
    features: np.ndarray, grid_size: int = 8
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Exact per-tile 8-D phi via OpenCV (reference morphology.py:741-796).

    features: (B, H, W, C) NHWC float.  Channel-mean -> per-image uint8 ->
    per-tile metrics.  Returns (phi (B, ht, wt, 8), detailed dict)."""
    if not HAS_CV2:
        raise RuntimeError("cv2 unavailable — exact backend disabled")
    B, H, W, C = features.shape
    tile = tile_size_for(H, grid_size)
    ht, wt = H // tile, W // tile

    gray_all = features.astype(np.float32).mean(axis=-1)  # (B, H, W)
    phi = np.zeros((B, ht, wt, 8), np.float32)
    detailed = {
        k: np.zeros((B, ht, wt), np.float32)
        for k in ("fractal", "texture", "gradient", "edge", "contour")
    }

    for b in range(B):
        g = gray_all[b]
        g8 = ((g - g.min()) / (g.max() - g.min() + 1e-8) * 255.0).astype(np.uint8)
        for i in range(ht):
            for j in range(wt):
                t8 = g8[i * tile : (i + 1) * tile, j * tile : (j + 1) * tile]
                edges = _otsu_canny(t8)
                p1 = fast_fractal_dimension((edges > 0).astype(np.uint8)) / 2.0
                p2 = compute_texture_entropy(t8)
                p3 = compute_gradient_variance(t8)
                p4 = compute_edge_density(t8)
                p5 = compute_contour_complexity(t8)
                detailed["fractal"][b, i, j] = p1
                detailed["texture"][b, i, j] = p2
                detailed["gradient"][b, i, j] = p3
                detailed["edge"][b, i, j] = p4
                detailed["contour"][b, i, j] = p5
                phi[b, i, j] = [
                    p1, p2, p3, p4, p5,
                    p1 * p2, p3**2, math.sqrt(max(p4 * p5, 0.0)),
                ]
    return phi, detailed


def score_image_cv2(
    features: np.ndarray, feature_weights: np.ndarray = None, grid_size: int = 8
) -> np.ndarray:
    """Eq.(8) deterministic per-image score with the exact backend."""
    phi, _ = phi_tiles_cv2(features, grid_size)
    alpha = (
        np.abs(feature_weights) if feature_weights is not None else np.ones(5) / 5.0
    )
    alpha = alpha / max(alpha.sum(), 1e-8)
    c = (phi[..., :5] * alpha.reshape(1, 1, 1, 5)).sum(-1)
    return np.clip(c.mean(axis=(1, 2)), 0.0, 1.0)


def edge_density_score(image: np.ndarray) -> float:
    """Model-free per-image complexity: the whole-image Canny edge density
    with cv2, else the share of pixels whose gradient magnitude exceeds its
    mean plus one standard deviation."""
    g = image.astype(np.float32)
    if g.ndim == 3:
        g = g.mean(-1)
    g8 = ((g - g.min()) / (g.max() - g.min() + 1e-8) * 255.0).astype(np.uint8)
    if HAS_CV2:
        edges = _otsu_canny(g8)
        return float((edges > 0).mean())
    gx, gy = np.gradient(g8.astype(np.float32))
    mag = np.abs(gx) + np.abs(gy)
    return float((mag > mag.mean() + mag.std()).mean())


def fit_feature_weights(phi: np.ndarray, c_mlp: np.ndarray) -> np.ndarray:
    """NNLS fit min_a ||Phi a - C||^2 s.t. a >= 0, normalized to the simplex
    (uniform when the fit is all zero): refits the Eq.(8) weights to the
    trained complexity MLP.  phi: (N, >= 5) descriptors (the first five
    used); c_mlp: (N,) MLP outputs."""
    from scipy.optimize import nnls

    P = np.asarray(phi, np.float64).reshape(-1, phi.shape[-1])[:, :5]
    C = np.asarray(c_mlp, np.float64).reshape(-1)
    alpha, _ = nnls(P, C)
    s = float(alpha.sum())
    return alpha / s if s > 1e-12 else np.ones(5) / 5.0
