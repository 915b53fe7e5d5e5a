"""The tile engines of the port (`core/morphology_lanes.py`, `tile_engine`)
against the JAX package on the CPU, on the same numpy-seeded inputs, and
the CUDA kernel's host side (geometry, argument checks, build flags), which
needs no card.

On the CPU both engines run the plain PyTorch ops: 'lanes' through the
registered op `mcaq::phi_tiles`, whose CPU kernel is the plain version, and
'rows' directly; they agree bitwise.  Tolerances against JAX: phi and the
detailed maps within 1e-5 abs, the class of `test_torch_morphology_options`
(the Canny ties of ROADMAP C need exactly symmetric gradients, which these
continuous random maps do not give).  The kernel itself is held to its plain
version on the card (`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.core import morphology as jmorph
from mcaq_yolo_tpu.core import morphology_lanes as jlanes
from mcaq_yolo_tpu_torch.core import image_ops as tiops
from mcaq_yolo_tpu_torch.core import morphology as tmorph
from mcaq_yolo_tpu_torch.core import morphology_lanes as tlanes
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.ops import build


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: many small CPU ops under the gate's
    six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPTIONS = list(itertools.product(["cv2compat", "legacy"], ["adaptive", "otsu"], [True, False]))
# (features shape, downsample): tile 4 on a (32, 48) map; tile 8 at 64 px,
# degraded by downsample 2 to tile 4 on a 32 x 32 gray map
SCALES = [((2, 32, 48, 4), 1), ((2, 64, 64, 3), 2)]


@pytest.mark.parametrize("shape,downsample", SCALES)
@pytest.mark.parametrize("canny_impl,binarize_impl,contour_components", OPTIONS)
def test_engines_match_jax(shape, downsample, canny_impl, binarize_impl, contour_components):
    kw = dict(canny_impl=canny_impl, binarize_impl=binarize_impl,
              contour_components=contour_components, downsample=downsample)
    f = np.random.default_rng(len(str(kw)) + shape[1]).normal(0, 1, shape).astype(np.float32)
    out = {e: tmorph.compute_phi_tiles(torch.from_numpy(f), tile_engine=e, **kw)
           for e in ("lanes", "rows")}
    assert torch.equal(out["lanes"][0], out["rows"][0])
    for engine in ("lanes", "rows"):
        ref_phi, ref_det = jmorph.compute_phi_tiles(jnp.asarray(f), tile_engine=engine, **kw)
        for e in ("lanes", "rows"):
            phi, det = out[e]
            assert phi.shape == ref_phi.shape
            np.testing.assert_allclose(phi.numpy(), np.asarray(ref_phi), atol=1e-5, rtol=0)
            for k in ref_det:
                np.testing.assert_allclose(det[k].numpy(), np.asarray(ref_det[k]),
                                           atol=1e-5, rtol=0)


@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16, 32])
def test_phi_metrics_tiled_matches_jax_lanes_at_every_tile(tile):
    """JAX's signature (five maps, phi1 unhalved) at each power-of-two tile
    the kernel takes (the tile's own maps: 1-2 on tiny maps, 4 and 8 on the
    model's, 16 and 32 on larger images).  JAX runs op by op, as the port
    does: under jit, XLA's fusion reorders float operations, and on 2 x 2
    tiles, whose replicated borders make gradients exactly symmetric, that
    flips NMS ties (ROADMAP C)."""
    B, ht, wt = 2, 3, 2
    gray = np.random.default_rng(tile).random((B, ht * tile, wt * tile)).astype(np.float32)
    gray = (gray - gray.min()) / (gray.max() - gray.min())
    ref = jlanes.phi_metrics_tiled(jnp.asarray(gray), tile, "cv2compat", "adaptive", True)
    out = tlanes.phi_metrics_tiled(torch.from_numpy(gray), tile)
    for a, r in zip(out, ref):
        assert a.shape == (B, ht, wt)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_op_on_the_cpu_is_the_plain_version():
    gray = tiops.normalize01(torch.from_numpy(
        np.random.default_rng(3).random((2, 16, 24)).astype(np.float32)))
    for canny, binarize, cc in OPTIONS:
        phi = tlanes.phi_tiles(gray, 4, canny, binarize, cc)
        plain = tlanes.phi_tiles_torch(gray, 4, canny, binarize, cc)
        assert torch.equal(phi, plain) and phi.shape == (2, 4, 6, 8)
        rows = tmorph.phi_metrics_tiled(gray, 4, canny, binarize, cc)
        for a, b in zip(tlanes.phi_metrics_tiled(gray, 4, canny, binarize, cc), rows):
            assert torch.equal(a, b)
    assert tlanes.phi_tiles.launches == 0  # the CPU launches no kernel


def test_opcheck():
    gray = tiops.normalize01(torch.from_numpy(
        np.random.default_rng(4).random((2, 8, 16)).astype(np.float32)))
    for args in ((gray, 4, "cv2compat", "adaptive", True), (gray, 8, "legacy", "otsu", False)):
        torch.library.opcheck(torch.ops.mcaq.phi_tiles.default, args)


@pytest.mark.parametrize("where", ["compute_phi_tiles", "analyzer", "model"])
def test_unknown_tile_engine_raises(where):
    """The port refuses an engine it does not have, as it refuses its other
    unknown options (JAX's `compute_phi_tiles` runs any value other than
    'lanes' as 'rows')."""
    with pytest.raises(ValueError, match="tile_engine"):
        if where == "compute_phi_tiles":
            tmorph.compute_phi_tiles(torch.zeros(1, 16, 16, 3), tile_engine="columns")
        elif where == "analyzer":
            tmorph.MorphologicalComplexityAnalyzer(tile_engine="columns")
        else:
            MCAQYOLO(num_classes=4, morph_tile_engine="columns", device="cpu")
    jphi, _ = jmorph.compute_phi_tiles(jnp.zeros((1, 16, 16, 3)), tile_engine="columns")
    assert jphi.shape == (1, 4, 4, 8)


@pytest.mark.parametrize("engine", ["lanes", "rows"])
def test_model_engine_reaches_the_analyzer(engine):
    model = MCAQYOLO(num_classes=4, morph_tile_engine=engine, device="cpu")
    assert model.complexity_analyzer.tile_engine == engine
    assert MCAQYOLO(num_classes=4, device="cpu").complexity_analyzer.tile_engine == "lanes"


def test_checkpoint_meta_engine_reaches_the_analyzer(tmp_path):
    """`morphology.tile_engine` of a checkpoint's meta through `Predictor`,
    and of a config through `Trainer`, ends in the analyzer."""
    from mcaq_yolo_tpu_torch.inference import Predictor
    from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
    from mcaq_yolo_tpu_torch.train import Trainer
    from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint

    model = MCAQYOLO(num_classes=4, device="cpu")
    ckpt = tmp_path / "m.ckpt"
    save_checkpoint(ckpt, to_jax_variables(model),
                    {"variant": "yolov8n", "num_classes": 4, "img_size": 64,
                     "config": {"morphology": {"tile_engine": "rows"}}})
    pred = Predictor(str(ckpt), warmup=False, device="cpu")
    assert pred.model.complexity_analyzer.tile_engine == "rows"

    batch = {"image": np.zeros((2, 64, 64, 3), np.uint8),
             "gt_boxes": np.zeros((2, 4, 4), np.float32),
             "gt_classes": np.zeros((2, 4), np.int32), "gt_mask": np.zeros((2, 4), bool)}
    cfg = {"model": {"num_classes": 4}, "data": {"img_size": 64}, "batch_size": 2,
           "distillation": {"enabled": False}, "output_dir": str(tmp_path / "t"),
           "morphology": {"tile_engine": "rows"}}
    trainer = Trainer(cfg, [batch], [batch], device="cpu")
    assert trainer.model.complexity_analyzer.tile_engine == "rows"


@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16, 32, 64, 128])
def test_launch_geometry(tile):
    """Groups of whole tiles, 256 pixel slots (one tile from 16 x 16 up);
    planes in shared memory up to tile 64, in a global scratch at 128."""
    n_tiles = 1000
    geo = tlanes.launch_geometry(n_tiles, tile)
    n = tile * tile
    assert geo.tiles_per_group * n == max(tlanes.SLOTS, n)
    assert geo.groups == -(-n_tiles // geo.tiles_per_group)
    assert geo.ws_bytes == tlanes.PLANE_BYTES_PER_PIXEL * geo.tiles_per_group * n
    assert geo.smem <= tlanes.MAX_SMEM
    assert geo.ws_global == (tile == 128)
    if geo.ws_global:
        assert geo.grid == min(geo.groups, tlanes.GLOBAL_BLOCKS)
        assert geo.scratch_bytes == geo.grid * geo.ws_bytes
        assert geo.smem == geo.tiles_per_group * 26 * 4 + 256 * 4
    else:
        assert geo.grid == geo.groups and geo.scratch_bytes == 0
        assert geo.smem == geo.tiles_per_group * 26 * 4 + 256 * 4 + geo.ws_bytes


@pytest.mark.parametrize("canny_impl,binarize_impl,contour_components", OPTIONS)
def test_kernel_args_carry_the_option_flags(canny_impl, binarize_impl, contour_components):
    gray = torch.zeros(3, 40, 24)
    ints, geo = tlanes.kernel_args(gray, 4, canny_impl, binarize_impl, contour_components)
    assert ints[:4] == (3, 10, 6, 2)
    assert ints[4:7] == (int(canny_impl == "legacy"), int(binarize_impl == "otsu"),
                         int(contour_components))
    assert ints[7:] == (geo.tiles_per_group, geo.grid, int(geo.ws_global), geo.ws_bytes,
                        geo.smem) == (16, 12, 0, 6400, 9088)


@pytest.mark.parametrize("gray,tile,match", [
    (torch.zeros(2, 16, 16), 3, "power of two"),
    (torch.zeros(2, 256, 256), 256, "power of two"),
    (torch.zeros(2, 16, 20), 8, "whole tiles"),
    (torch.zeros(2, 16, 16, dtype=torch.float64), 4, "float32"),
    (torch.zeros(2, 16, 32)[:, :, ::2], 4, "contiguous"),
    (torch.zeros(16, 16), 4, r"\(B, H, W\)"),
])
def test_kernel_refuses_what_it_does_not_take(gray, tile, match):
    with pytest.raises(ValueError, match=match):
        tlanes.kernel_args(gray, tile, "cv2compat", "adaptive", True)
    with pytest.raises(ValueError, match=match):
        tlanes.phi_tiles(gray, tile)  # the CPU op checks alike


def test_kernel_refuses_an_unknown_option():
    with pytest.raises(ValueError, match="canny_impl"):
        tlanes.kernel_args(torch.zeros(1, 8, 8), 4, "sobel", "adaptive", True)
    with pytest.raises(ValueError, match="binarize_impl"):
        tlanes.phi_tiles(torch.zeros(1, 8, 8), 4, "cv2compat", "mean", True)


def test_build_flags_per_kernel():
    """The phi kernel is built without FMA contraction; the quantize kernel's
    flags (and so its library's hash) are those of its first build."""
    assert "morph_tiles" in build.KERNELS and "spatial_quant" in build.KERNELS
    assert "--fmad=false" in build.nvcc_flags("morph_tiles")
    assert build._source_and_flags("morph_tiles")[1] == build.nvcc_flags("morph_tiles")
    assert build._source_and_flags("spatial_quant")[1] == (
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v") == build.NVCC_FLAGS
    assert build._source_and_flags("morph_tiles")[0].is_file()
    assert build.library_path("morph_tiles").name.startswith("libmorph_tiles-")


def test_bound_counts():
    gray = torch.zeros(32, 40, 40)
    assert tlanes.phi_tiles_bytes(gray, 4) == 32 * 40 * 40 * 4 + 32 * 100 * 8 * 4
    full = tlanes.phi_tiles_ops(gray.numel())
    assert full == sum(tlanes.OPS_PER_PIXEL[k] for k in (
        "phi3_sobel", "canny_cv2compat", "binarize_adaptive", "lbp", "contour", "euler",
        "box_counts", "edge_density")) * gray.numel()
    assert tlanes.phi_tiles_ops(gray.numel(), "legacy", "otsu", False) < full
