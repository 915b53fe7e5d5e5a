"""The morphology options kept for ablation (`canny_impl='legacy'`,
`binarize_impl='otsu'`, `contour_components=False`, `metric_mode='global'`)
and the whole-image helpers of `core/image_ops.py`, against the JAX
reference on the CPU, on the same numpy-seeded inputs.

Tolerances:
  * `image_ops` helpers: 1e-6 abs (F.conv2d and XLA's conv sum the taps in
    another order); max pool, histogram and Otsu threshold exactly equal;
  * phi maps and complexity: 1e-5 abs away from Canny ties (the class of
    `test_torch_model.py`), against JAX's `tile_engine='lanes'` in the
    tiled mode; bit maps exactly equal;
  * global mode's tie rate: the whole-image Canny edge maps are compared
    pixel by pixel; at these seeds 0 pixels differ (the ties of ROADMAP C
    need exactly symmetric gradients, which continuous random maps do not
    give), so phi's 1e-5 holds on every tile.
"""

import inspect
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.core import bit_allocation as jba
from mcaq_yolo_tpu.core import image_ops as jiops
from mcaq_yolo_tpu.core import morphology as jmorph
from mcaq_yolo_tpu_torch.core import bit_allocation as tba
from mcaq_yolo_tpu_torch.core import image_ops as tiops
from mcaq_yolo_tpu_torch.core import morphology as tmorph
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: many small CPU ops under the gate's
    six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_K5 = np.outer([1, 4, 6, 4, 1], [1, 2, 3, 2, 1]).astype(np.float32) / 81.0

HELPERS = {
    "max_pool_3_s1_p1": (lambda x: jiops.max_pool(x, 3, 1, 1),
                         lambda x: tiops.max_pool(x, 3, 1, 1), 0.0),
    "max_pool_4": (lambda x: jiops.max_pool(x, 4), lambda x: tiops.max_pool(x, 4), 0.0),
    "conv2d_replicate": (lambda x: jiops.conv2d_replicate(x, jnp.asarray(_K5)),
                         lambda x: tiops.conv2d_replicate(x, torch.from_numpy(_K5)), 1e-6),
    "conv2d_zero": (lambda x: jiops.conv2d_zero(x, jnp.asarray(_K5)),
                    lambda x: tiops.conv2d_zero(x, torch.from_numpy(_K5)), 1e-6),
    "gaussian_blur_zero": (lambda x: jiops.gaussian_blur(x, 5, 1.0, "zero"),
                           lambda x: tiops.gaussian_blur(x, 5, 1.0, "zero"), 1e-6),
    "gaussian_blur_edge": (lambda x: jiops.gaussian_blur(x, 11, 1.7, "edge"),
                           lambda x: tiops.gaussian_blur(x, 11, 1.7, "edge"), 1e-6),
    "sobel_zero": (lambda x: jnp.stack(jiops.sobel(x, "zero")),
                   lambda x: torch.stack(tiops.sobel(x, "zero")), 1e-6),
    "sobel_edge": (lambda x: jnp.stack(jiops.sobel(x, "edge")),
                   lambda x: torch.stack(tiops.sobel(x, "edge")), 1e-6),
    "histogram01": (lambda x: jiops.histogram01(x.reshape(x.shape[0], -1)),
                    lambda x: tiops.histogram01(x.reshape(x.shape[0], -1)), 0.0),
    "otsu_threshold": (jiops.otsu_threshold, tiops.otsu_threshold, 0.0),
}


SHIFT_OPS = {
    "dilate3": (jiops.dilate3, tmorph.dilate3, 0.0),
    "erode3": (jiops.erode3, tmorph.erode3, 0.0),
    "sobel_edge": (lambda x: jnp.stack(jiops.sobel(x, "edge")),
                   lambda x: torch.stack(tmorph.sobel(x, "edge")), 1e-5),
    "sobel_zero": (lambda x: jnp.stack(jiops.sobel(x, "zero")),
                   lambda x: torch.stack(tmorph.sobel(x, "zero")), 1e-5),
}


@pytest.mark.parametrize("name", sorted(SHIFT_OPS))
def test_shift_operators_take_non_square_maps(name):
    """The shift-add operators of `morphology.py` on whole (B, H, W) maps
    with H != W: dilation and erosion of {0, 1} maps exactly equal to
    JAX's whole-image ones; the separable Sobel within 1e-5 of JAX's
    non-separable conv (the taps summed in another order)."""
    jf, tf, atol = SHIFT_OPS[name]
    x = np.random.default_rng(8).random((3, 24, 40)).astype(np.float32)
    if name in ("dilate3", "erode3"):
        x = (x > 0.6).astype(np.float32)
    ref = np.asarray(jax.jit(jf)(jnp.asarray(x)))
    out = tf(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_image_ops_match_jax(name):
    """(B, H, W) non-square maps in [0, 1]."""
    jf, tf, atol = HELPERS[name]
    x = np.random.default_rng(7).random((3, 24, 40)).astype(np.float32)
    ref = np.asarray(jax.jit(jf)(jnp.asarray(x)))
    out = tf(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


def test_phi_signature_matches_jax():
    """The positional order is JAX's, so a positional caller lands on the
    same option in either package (JAX's last, `tile_engine`, is the
    reference's choice of TPU layout, which the port does not take)."""
    j = list(inspect.signature(jmorph.compute_phi_tiles).parameters)
    t = list(inspect.signature(tmorph.compute_phi_tiles).parameters)
    assert t == j[:-1] and j[-1] == "tile_engine"
    ja = [f for f in jmorph.MorphologicalComplexityAnalyzer.__dataclass_fields__
          if f not in ("parent", "name", "tile_engine")]
    ta = list(inspect.signature(tmorph.MorphologicalComplexityAnalyzer).parameters)
    assert ta == ja


@pytest.mark.parametrize("option,value", [("canny_impl", "canny"), ("binarize_impl", "mean"),
                                          ("metric_mode", "rows")])
def test_unknown_option_raises(option, value):
    with pytest.raises(ValueError, match=option):
        tmorph.compute_phi_tiles(torch.zeros(1, 16, 16, 3), **{option: value})


OPTIONS = list(itertools.product(["cv2compat", "legacy"], ["adaptive", "otsu"],
                                 [True, False], ["tiled", "global"]))


@pytest.mark.parametrize("canny_impl,binarize_impl,contour_components,metric_mode", OPTIONS)
def test_phi_options_match_jax(canny_impl, binarize_impl, contour_components, metric_mode):
    """A non-square (32, 48) map: tile 4, a 8 x 12 grid."""
    kw = dict(canny_impl=canny_impl, binarize_impl=binarize_impl,
              contour_components=contour_components, metric_mode=metric_mode)
    f = np.random.default_rng(len(str(kw))).normal(0, 1, (2, 32, 48, 4)).astype(np.float32)
    ref_phi, ref_det = jax.jit(
        lambda a: jmorph.compute_phi_tiles(a, tile_engine="lanes", **kw))(jnp.asarray(f))
    phi, det = tmorph.compute_phi_tiles(torch.from_numpy(f), **kw)
    assert phi.shape == ref_phi.shape == (2, 8, 12, 8)
    np.testing.assert_allclose(phi.numpy(), np.asarray(ref_phi), atol=1e-5, rtol=0)
    for k in ref_det:
        np.testing.assert_allclose(det[k].numpy(), np.asarray(ref_det[k]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("canny_impl", ["cv2compat", "legacy"])
@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 64, 64)])
def test_global_canny_tie_rate(canny_impl, shape):
    """The whole-image Canny edge maps pixel by pixel: the tie rate is the
    share of pixels that differ, 0 at these seeds."""
    g = jiops.normalize01(jnp.asarray(
        np.random.default_rng(sum(shape)).random(shape).astype(np.float32)))
    if canny_impl == "legacy":
        ref, out = jax.jit(jmorph.canny_legacy)(g), tmorph.canny_legacy_image
    else:
        ref = jax.jit(lambda a: jmorph.canny_cv2compat(a, pad_mode="zero"))(g)
        out = tmorph.canny_cv2compat_image
    edge = out(torch.from_numpy(np.array(g))).numpy()
    assert edge.shape == ref.shape and 0 < edge.mean() < 1
    tie_rate = float(np.mean(edge != np.asarray(ref)))
    assert tie_rate == 0.0


@pytest.mark.parametrize("kw", [
    dict(metric_mode="global"),
    dict(metric_mode="global", canny_impl="legacy", binarize_impl="otsu",
         contour_components=False),
    dict(metric_mode="tiled", canny_impl="legacy", binarize_impl="otsu",
         contour_components=False, downsample=2),
], ids=["global", "global_legacy", "tiled_legacy_ds2"])
def test_analyzer_options_match_jax(kw):
    """The analyzer with weights carried by `load_jax_variables`: complexity
    within 1e-5, and the linear mapper's rounded bits equal."""
    f = np.random.default_rng(11).normal(0, 1, (2, 64, 64, 8)).astype(np.float32)
    ja = jmorph.MorphologicalComplexityAnalyzer(**kw)
    v = jax.jit(ja.init)(jax.random.PRNGKey(5), jnp.asarray(f))
    v = jax.tree_util.tree_map(np.asarray, v)
    ref = np.asarray(jax.jit(ja.apply)(v, jnp.asarray(f)))
    port = load_jax_variables(tmorph.MorphologicalComplexityAnalyzer(**kw), v)
    with torch.no_grad():
        out = port(torch.from_numpy(f))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    bits = tba.LinearBitMapper()(out)
    ref_bits = np.asarray(jba.LinearBitMapper().apply({}, jnp.asarray(ref)))
    np.testing.assert_array_equal(bits.numpy(), ref_bits)
    assert len(np.unique(ref_bits)) > 1
