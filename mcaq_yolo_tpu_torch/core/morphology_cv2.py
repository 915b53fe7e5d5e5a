"""
Host-side NumPy / cv2 helpers of the curriculum (a subset of
`mcaq_yolo_tpu/core/morphology_cv2.py`): the model-free edge-density score
(`:213-225`, both branches) and the NNLS refit of the Eq.(8) weights
(`:233-245`).

The exact cv2 metric backend (`phi_tiles_cv2`, `score_image_cv2`) is not
ported yet: `curriculum.score_backend: cv2` raises in `Trainer`.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    HAS_CV2 = True
except ImportError:  # cv2 is optional
    HAS_CV2 = False


def _otsu_canny(gray_u8: np.ndarray) -> np.ndarray:
    """Gaussian blur (5x5, sigma 1) -> Otsu threshold on the blurred
    intensity -> Canny with (0.5 t, t)."""
    blurred = cv2.GaussianBlur(gray_u8, (5, 5), 1.0)
    otsu_thr, _ = cv2.threshold(blurred, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    return cv2.Canny(blurred, int(max(0, 0.5 * otsu_thr)), int(max(1, otsu_thr)))


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
