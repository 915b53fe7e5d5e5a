"""The port's data layer (`data/dataset.py`, `data/native_loader.py`,
`core/morphology_cv2.py`, Eq.(8) scoring) against the JAX
package on the CPU, with inputs made from seeds.

Tolerances:
  * generators: decoded images and label files equal;
  * `get_item`, clean and augmented (mosaic, HSV, affine, flip) on images
    resized by the letterbox: labels equal, pixels within 1 level per
    channel (the port resizes with its native letterbox, the reference here
    with cv2's; both bilinear, rounded differently);
  * the native letterbox bitwise equal to the reference's C++ built from
    `native/`, and within 1 level of cv2's resize;
  * loader order, prefetch, sampler, fingerprint, scores cache: equal;
  * Eq.(8) scores of float images away from gray-level ties within 1e-5;
    the edge-density score and the NNLS refit within 1e-12.
"""

import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.core import morphology_cv2 as jcv2
from mcaq_yolo_tpu.data import dataset as jd
from mcaq_yolo_tpu_torch.core import morphology_cv2 as tcv2
from mcaq_yolo_tpu_torch.data import dataset as td
from mcaq_yolo_tpu_torch.data import native_loader

S = 64  # letterboxed size; the images are written at 80 x 80 (scale 0.8)


@pytest.fixture(scope="module")
def yaml_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("v3")
    return jd.make_synthetic_dataset_v3(str(root), n_images=12, img_size=80, n_val=4, seed=5)


def _pair(yaml_path, **kw):
    d = jd.load_dataset_yaml(yaml_path)
    assert td.load_dataset_yaml(yaml_path) == d
    return (jd.YOLODataset(d["train"], S, 24, seed=11, **kw),
            td.YOLODataset(d["train"], S, 24, seed=11, **kw))


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("gen,kw", [
    ("make_synthetic_dataset", dict(n_images=3, img_size=48, n_classes=4)),
    ("make_synthetic_dataset_v2", dict(n_images=3, img_size=64, n_val=2)),
    ("make_synthetic_dataset_v3", dict(n_images=3, img_size=64, n_val=2)),
    ("make_natural_statistics_images", dict(n_images=3, img_size=48)),
])
def test_generators_write_the_same_dataset(tmp_path, gen, kw):
    getattr(jd, gen)(str(tmp_path / "jax"), seed=3, **kw)
    getattr(td, gen)(str(tmp_path / "port"), seed=3, **kw)
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port") and files
    for f in files:
        a, b = tmp_path / "jax" / f, tmp_path / "port" / f
        if f.suffix in (".png", ".jpg"):
            np.testing.assert_array_equal(td.read_image(str(a)), td.read_image(str(b)))
        else:
            assert a.read_text().replace("jax", "port") == b.read_text(), f


def test_clean_items_match(yaml_path):
    jds, tds = _pair(yaml_path)
    assert tds.files_fingerprint() == jds.files_fingerprint()
    for i in range(len(jds)):
        a, b = jds.get_item(i), tds.get_item(i)
        for k in ("gt_boxes", "gt_classes", "gt_mask", "path", "orig_hw", "pad"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # the native letterbox returns its scale in float32 (as the reference's
        # native path does); the boxes are float32 either way
        assert b["scale"] == pytest.approx(a["scale"], rel=1e-7)
        diff = np.abs(a["image"].astype(int) - b["image"].astype(int))
        assert diff.max() <= 1, diff.max()


def test_augmented_items_match(yaml_path):
    """mosaic 1.0, HSV 0.5, scale 0.5, translate 0.1, flip 0.5: the same
    draws from `dataset.rng` in the same order."""
    aug = dict(augment=True, mosaic_p=1.0, hsv_p=0.5, hflip_p=0.5, scale_jitter=0.5,
               translate=0.1, cache_images=True)
    jds, tds = _pair(yaml_path, **aug)
    n_boxes = 0
    for i in list(range(len(jds))) * 2:
        a, b = jds.get_item(i), tds.get_item(i)
        for k in ("gt_boxes", "gt_classes", "gt_mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        diff = np.abs(a["image"].astype(int) - b["image"].astype(int))
        assert diff.max() <= 1, (i, diff.max())
        n_boxes += int(a["gt_mask"].sum())
    assert n_boxes > 0
    assert jds.rng.random() == tds.rng.random()  # the generators are in step


def test_loader_order_prefetch_and_subsets(yaml_path):
    jds, tds = _pair(yaml_path)
    ref = [b["paths"] for b in jd.DataLoader(jds, 4, shuffle=True, seed=7,
                                             indices=[9, 2, 5, 0, 7, 3, 11, 1, 4])]
    sync = list(td.DataLoader(tds, 4, shuffle=True, seed=7, indices=[9, 2, 5, 0, 7, 3, 11, 1, 4]))
    pre = list(td.DataLoader(tds, 4, shuffle=True, seed=7, num_workers=2,
                             indices=[9, 2, 5, 0, 7, 3, 11, 1, 4]))
    assert [b["paths"] for b in sync] == ref == [b["paths"] for b in pre]
    assert len(sync) == len(td.DataLoader(tds, 4, indices=range(9))) == 2
    for a, b in zip(sync, pre):
        for k in ("image", "gt_boxes", "gt_classes", "gt_mask"):
            np.testing.assert_array_equal(a[k], b[k])
    ragged = list(td.DataLoader(tds, 5, drop_last=False))
    assert [len(b["paths"]) for b in ragged] == [5, 5, 2]


def test_prefetch_loader_propagates_errors(yaml_path):
    _, tds = _pair(yaml_path)
    loader = td.DataLoader(tds, 4, num_workers=1)

    def boom(_):
        raise RuntimeError("producer failure")

    loader._assemble = boom
    with pytest.raises(RuntimeError, match="producer failure"):
        list(loader)


def test_prefetch_loader_retires_an_abandoned_iteration(yaml_path):
    _, tds = _pair(yaml_path)
    loader = td.DataLoader(tds, 2, num_workers=1, prefetch_depth=1)
    before = threading.active_count()
    for _ in range(3):
        for batch in loader:
            assert batch["image"].shape == (2, S, S, 3)
            break  # abandoned: closing the generator retires the producer
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert "_loader_lock" in tds.__dict__  # shared by every loader of the dataset


def test_scores_cache_is_read_by_either_package(yaml_path, tmp_path):
    jds, tds = _pair(yaml_path)
    scores = np.linspace(0.1, 0.9, len(jds)).astype(np.float32)
    never = lambda images: pytest.fail("the cache was not used")  # noqa: E731
    for writer, reader, ds_w, ds_r, name in ((td, jd, tds, jds, "p"), (jd, td, jds, tds, "j")):
        cache = str(tmp_path / f"{name}.npy")
        out = writer.compute_dataset_complexity(
            ds_w, lambda im, it=iter(np.split(scores, [8])): next(it), cache_path=cache,
            backend="train-eq8")
        np.testing.assert_array_equal(out, scores)
        np.testing.assert_array_equal(
            reader.compute_dataset_complexity(ds_r, never, cache_path=cache,
                                              backend="train-eq8"), scores)


def test_balanced_sampler_and_folder_scores(yaml_path):
    scores = np.random.default_rng(0).random(37)
    for bins, seed in ((10, 0), (4, 3)):
        np.testing.assert_array_equal(
            td.create_complexity_balanced_sampler(scores, bins, seed),
            jd.create_complexity_balanced_sampler(scores, bins, seed))
    folder = jd.load_dataset_yaml(yaml_path)["val"]
    a = jd.score_image_folder(folder, img_size=S)
    b = td.score_image_folder(folder, img_size=S)
    assert a.keys() == b.keys()
    for k in a:  # edge density of images within 1 level of each other
        assert b[k] == pytest.approx(a[k], abs=0.02)


def test_native_letterbox_matches_the_reference_library(tmp_path):
    """csrc/dataio.cpp against native/mcaq_dataio.cpp built here into a
    temporary directory: bitwise; and within 1 level of cv2's resize."""
    import ctypes

    cv2 = pytest.importorskip("cv2")
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "native" / "mcaq_dataio.cpp"
    lib_path = tmp_path / "libref.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=120)
    ref = ctypes.CDLL(str(lib_path))
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    ref.mcaq_letterbox_u8.restype = ctypes.c_float
    ref.mcaq_letterbox_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_uint8, u8p, i32p, i32p]
    ref.mcaq_letterbox_f32.restype = ctypes.c_float
    ref.mcaq_letterbox_f32.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                                       i32p, i32p]
    rng = np.random.default_rng(4)
    for h, w, size in ((80, 120, 64), (150, 60, 96), (33, 47, 64), (64, 64, 64), (90, 90, 160)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out, scale, pad = native_loader.letterbox_u8(img, size)
        expect = np.empty_like(out)
        px, py = ctypes.c_int(), ctypes.c_int()
        s = ref.mcaq_letterbox_u8(img.ctypes.data_as(u8p), h, w, size, 114,
                                  expect.ctypes.data_as(u8p), ctypes.byref(px),
                                  ctypes.byref(py))
        np.testing.assert_array_equal(out, expect)
        assert (scale, pad) == (s, (px.value, py.value))
        out32, _, _ = native_loader.letterbox_f32(img, size)
        e32 = np.empty((size, size, 3), np.float32)
        ref.mcaq_letterbox_f32(img.ctypes.data_as(u8p), h, w, size, 114.0,
                               e32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               ctypes.byref(px), ctypes.byref(py))
        np.testing.assert_array_equal(out32, e32)
        np.testing.assert_array_equal(native_loader.hflip_f32(out32), out32[:, ::-1])
        if (h, w) != (size, size):
            lb, _, _ = jd.letterbox(img, size)  # cv2 INTER_LINEAR
            assert np.abs(out.astype(int) - lb.astype(int)).max() <= 1
    assert cv2 is not None


def test_without_cv2_or_pil(yaml_path, tmp_path, monkeypatch):
    """No cv2: HSV and the affine are skipped with one warning naming the
    device pipeline, and images go through PIL; no cv2 and no PIL: reading
    and writing images raise, naming both libraries."""
    monkeypatch.setattr(td, "HAS_CV2", False)
    d = td.load_dataset_yaml(yaml_path)
    with pytest.warns(UserWarning, match="device_pipeline"):
        ds = td.YOLODataset(d["train"], S, 24, augment=True, mosaic_p=0.0, hsv_p=1.0,
                            hflip_p=0.0)
    img = ds._read_image(ds.img_files[0])
    np.testing.assert_array_equal(ds._hsv_jitter(img), img)
    boxes = np.array([[1.0, 2.0, 30.0, 40.0]], np.float32)
    out = ds._affine(img, boxes, np.array([3]))
    assert out[0] is img and out[1] is boxes
    td.write_image(tmp_path / "x.png", img)
    np.testing.assert_array_equal(td.read_image(str(tmp_path / "x.png")), img)
    monkeypatch.setattr(td, "HAS_PIL", False)
    with pytest.raises(RuntimeError, match="neither cv2 nor PIL"):
        td.read_image(ds.img_files[0])
    with pytest.raises(RuntimeError, match="neither cv2 nor PIL"):
        td.write_image(tmp_path / "y.png", img)


@pytest.mark.parametrize("has_cv2", [True, False])
def test_edge_density_score_matches(has_cv2, monkeypatch):
    monkeypatch.setattr(jcv2, "HAS_CV2", has_cv2)
    monkeypatch.setattr(tcv2, "HAS_CV2", has_cv2)
    rng = np.random.default_rng(8)
    for shape in ((64, 64, 3), (40, 56)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        assert tcv2.edge_density_score(img) == pytest.approx(jcv2.edge_density_score(img),
                                                             abs=1e-12)


def test_fit_feature_weights_matches():
    rng = np.random.default_rng(9)
    phi = rng.random((300, 8))
    c = phi[:, :5] @ np.array([0.5, 0.0, 0.2, 0.3, 0.0]) + rng.normal(0, 0.01, 300)
    a, b = tcv2.fit_feature_weights(phi, c), jcv2.fit_feature_weights(phi, c)
    np.testing.assert_allclose(a, b, atol=1e-12)
    assert a.sum() == pytest.approx(1.0) and (a >= 0).all()
    np.testing.assert_array_equal(tcv2.fit_feature_weights(phi, -np.ones(300)),
                                  np.ones(5) / 5.0)


@pytest.mark.parametrize("size,grid", [(96, 8), (128, 2)])
def test_eq8_scores_match_on_float_images(size, grid):
    """score_image_eq8 (model-free) and the analyzer's score_image with a
    refit alpha and downsample 2, on smooth float images (no gray ties).
    (128, 2) runs the engine on 64 x 64 tiles, the tile of a 640 px image
    at grid 8 (the largest power of two <= 640 / 8)."""
    import jax.numpy as jnp

    from mcaq_yolo_tpu.core.morphology import MorphologicalComplexityAnalyzer as JaxAnalyzer
    from mcaq_yolo_tpu.core.morphology import score_image_eq8 as jax_eq8
    from mcaq_yolo_tpu_torch.core.morphology import (
        MorphologicalComplexityAnalyzer,
        score_image_eq8,
    )

    rng = np.random.default_rng(10)
    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    imgs = np.stack([np.stack([np.sin(6 * xx * f + 2 * yy) * 0.4 + 0.5 + 0.05 * k
                               for k in range(3)], -1) for f in (1.0, 2.3, 4.1)])
    imgs = (imgs + rng.normal(0, 0.02, imgs.shape)).astype(np.float32)
    alpha = np.array([0.1, 0.4, 0.0, 0.3, 0.2], np.float32)
    np.testing.assert_allclose(score_image_eq8(torch.from_numpy(imgs), grid).numpy(),
                               np.asarray(jax_eq8(jnp.asarray(imgs), grid)), atol=1e-5)
    np.testing.assert_allclose(
        score_image_eq8(torch.from_numpy(imgs), grid, alpha).numpy(),
        np.asarray(jax_eq8(jnp.asarray(imgs), grid, jnp.asarray(alpha))), atol=1e-5)
    analyzer = MorphologicalComplexityAnalyzer(grid_size=grid, downsample=2)
    analyzer.feature_weights.copy_(torch.from_numpy(alpha))
    jan = JaxAnalyzer(grid_size=grid, downsample=2)
    jv = jan.init(__import__("jax").random.PRNGKey(0), jnp.asarray(imgs))
    jv = {**jv, "buffers": {"feature_weights": jnp.asarray(alpha)}}
    np.testing.assert_allclose(
        analyzer.score_image(torch.from_numpy(imgs)).numpy(),
        np.asarray(jan.apply(jv, jnp.asarray(imgs), method="score_image")), atol=1e-5)
