"""The port's exact OpenCV metric backend (`mcaq_yolo_tpu_torch/core/
morphology_cv2.py`) against the JAX package's on the CPU.

Both are host NumPy and cv2 arithmetic on the same inputs, so every metric,
phi and Eq.(8) score is held BITWISE: uint8 images at 96 px (8 x 8 tiles,
the Trainer's scoring input), float NHWC feature maps (several channels,
another tile size), feature weights given and not, and each per-tile metric
on its own."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mcaq_yolo_tpu.core import morphology_cv2 as jm  # noqa: E402
from mcaq_yolo_tpu_torch.core import morphology_cv2 as pm  # noqa: E402


def _images(seed, n=3, size=96):
    """Seeded uint8 RGB images with structure (rectangles, a disc, noise)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 40, (n, size, size, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for img in out:
        for _ in range(6):
            x0, y0 = rng.integers(0, size - 16, 2)
            w, h = rng.integers(6, 30, 2)
            img[y0:y0 + h, x0:x0 + w] = rng.integers(60, 255, 3)
        cx, cy, r = rng.integers(20, size - 20, 3) // 2 + 10
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 255, 3)
    return out


def test_phi_tiles_bitwise():
    images = _images(0)
    phi_p, det_p = pm.phi_tiles_cv2(images, grid_size=8)
    phi_j, det_j = jm.phi_tiles_cv2(images, grid_size=8)
    assert phi_p.shape == (3, 12, 12, 8)
    np.testing.assert_array_equal(phi_p, phi_j)
    assert det_p.keys() == det_j.keys()
    for k in det_p:
        np.testing.assert_array_equal(det_p[k], det_j[k], err_msg=k)
    assert phi_p[..., :5].std() > 0.01  # the metrics are not degenerate


@pytest.mark.parametrize("weights", [None, np.array([0.5, -0.1, 0.2, 0.0, 0.3])])
def test_score_image_bitwise(weights):
    images = _images(1, n=4)
    sp = pm.score_image_cv2(images, weights, grid_size=8)
    sj = jm.score_image_cv2(images, weights, grid_size=8)
    assert sp.shape == (4,)
    np.testing.assert_array_equal(sp, sj)


def test_float_features_other_tile_size_bitwise():
    rng = np.random.default_rng(2)
    feats = rng.normal(0, 1, (2, 40, 40, 16)).astype(np.float32)
    feats[:, 10:25, 5:30] += 2.0
    for grid in (4, 8):
        np.testing.assert_array_equal(pm.score_image_cv2(feats, grid_size=grid),
                                      jm.score_image_cv2(feats, grid_size=grid))


def test_each_metric_bitwise():
    rng = np.random.default_rng(3)
    tile = _images(3, n=1, size=48)[0]
    gray = cv2.cvtColor(tile, cv2.COLOR_RGB2GRAY)
    for fn in ("compute_texture_entropy", "compute_gradient_variance",
               "compute_edge_density", "compute_contour_complexity"):
        for t in (tile, gray):
            assert getattr(pm, fn)(t) == getattr(jm, fn)(t), fn
    edges = (rng.uniform(size=(48, 48)) > 0.7).astype(np.uint8)
    assert pm.fast_fractal_dimension(edges) == jm.fast_fractal_dimension(edges)
    np.testing.assert_array_equal(pm._uniform_lbp(gray), jm._uniform_lbp(gray))
