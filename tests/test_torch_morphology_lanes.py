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

import ctypes
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


def test_tile_256_matches_jax_lanes():
    """ROADMAP C.5: tile 256 (grid 2 on 512 px; `tile_size_for` gives it from
    2048 px at grid 8), which the CPU op takes as it takes any power of two,
    agrees with JAX's lanes engine, which takes any tile."""
    gray = np.random.default_rng(256).random((1, 512, 512)).astype(np.float32)
    gray = (gray - gray.min()) / (gray.max() - gray.min())
    ref = jlanes.phi_metrics_tiled(jnp.asarray(gray), 256, "cv2compat", "adaptive", True)
    out = tlanes.phi_metrics_tiled(torch.from_numpy(gray), 256)
    for a, r in zip(out, ref):
        assert a.shape == (1, 2, 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    assert tlanes.phi_tiles.launches == 0


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
    """Tiles up to 8 x 8: whole tiles per warp (32 / tile^2, one 8 x 8), 4
    warps a block, no shared memory; from 16 x 16 one tile per block of 256
    threads, its planes in shared memory up to tile 64, in a global scratch
    at 128."""
    n_tiles = 1000
    geo = tlanes.launch_geometry(n_tiles, tile)
    n = tile * tile
    assert geo.warp_path == (tile <= 8)
    if geo.warp_path:
        assert geo.tiles_per_warp == max(1, 32 // n) and geo.threads == 128
        assert geo.tiles_per_block == 4 * geo.tiles_per_warp
        assert geo.grid == -(-n_tiles // geo.tiles_per_block)
        assert (geo.ws_global, geo.ws_bytes, geo.smem, geo.scratch_bytes) == (False, 0, 0, 0)
    else:
        assert (geo.tiles_per_warp, geo.tiles_per_block, geo.threads) == (0, 1, 256)
        assert geo.ws_bytes == tlanes.PLANE_BYTES_PER_PIXEL * n
        assert geo.smem <= tlanes.MAX_SMEM
        assert geo.ws_global == (tile == 128)
        if geo.ws_global:
            assert geo.grid == min(n_tiles, tlanes.GLOBAL_BLOCKS)
            assert geo.scratch_bytes == geo.grid * geo.ws_bytes
            assert geo.smem == tlanes.HEADER_BYTES
        else:
            assert geo.grid == n_tiles and geo.scratch_bytes == 0
            assert geo.smem == tlanes.HEADER_BYTES + geo.ws_bytes


@pytest.mark.parametrize("tile,n_tiles", [(4, 1), (4, 31), (4, 33), (1, 129), (2, 40), (8, 5)])
def test_warp_path_covers_every_tile_once(tile, n_tiles):
    """Structural, from `launch_geometry` alone: a warp's tiles fill its 32
    lanes (two pixels a lane at 8 x 8), a block is 4 warps, and the grid is
    the fewest blocks that hold every tile of a ragged tail, so the last
    block is partly filled and no block is empty.  That the kernel's own
    indexing takes each tile once is held on the card
    (`test_phi_kernel_bitwise_on_ragged_tails`)."""
    geo = tlanes.launch_geometry(n_tiles, tile)
    n = tile * tile
    assert geo.warp_path and geo.threads == 4 * 32
    assert geo.tiles_per_warp * n == max(32, n) and n <= 2 * 32
    assert geo.tiles_per_block == 4 * geo.tiles_per_warp
    assert (geo.grid - 1) * geo.tiles_per_block < n_tiles <= geo.grid * geo.tiles_per_block


@pytest.mark.parametrize("tile,n_tiles", [(16, 3), (32, 1000), (64, 264), (128, 100),
                                          (128, 5000), (256, 64), (256, 512), (1024, 3)])
def test_block_path_grid(tile, n_tiles):
    """One tile per block; from 128 x 128 the planes (400 KB, 1.6 MB at 256)
    exceed shared memory, so at most GLOBAL_BLOCKS blocks stride over the
    tiles, each with its own scratch slice."""
    geo = tlanes.launch_geometry(n_tiles, tile)
    assert not geo.warp_path and geo.tiles_per_block == 1
    if tile >= 128:
        assert geo.ws_global and geo.grid == min(n_tiles, tlanes.GLOBAL_BLOCKS)
        assert geo.scratch_bytes == geo.grid * tlanes.PLANE_BYTES_PER_PIXEL * tile * tile
        strided = [list(range(b, n_tiles, geo.grid)) for b in range(geo.grid)]
        assert sorted(t for s in strided for t in s) == list(range(n_tiles))
    else:
        assert not geo.ws_global and geo.grid == n_tiles
        assert geo.smem == tlanes.HEADER_BYTES + tlanes.PLANE_BYTES_PER_PIXEL * tile * tile


def test_warp_path_has_no_block_barrier():
    """Structural, a search of the source text between the two paths'
    section comments: the warp path (tiles up to 8 x 8) synchronizes only
    within a warp, with no __syncthreads and no shared memory.  (On the
    card, `cuobjdump --dump-resource-usage` of the built library shows its
    instances' shared memory and stack.)"""
    src = build._source_and_flags("morph_tiles")[0].read_text()
    start = src.index("// ---- warp path")
    body = src[start:src.index("// ---- block path", start)]
    assert "phi_warp_kernel" in body
    assert "__syncthreads" not in body and "__shared__" not in body


@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16, 32, 64, 128])
def test_kernel_otsu_bin_is_the_plain_versions_up_to_128(tile):
    """The kernel's bitwise argument for Otsu: up to 128 x 128 its integer
    scan picks the plain version's bin on every Otsu input of every option
    (random tiles, constant tiles, two-valued tiles with tied runs)."""
    rng = np.random.default_rng(tile + 7)
    g = rng.random((6, tile, tile)).astype(np.float32)
    g[1] = 0.5
    g[2] = np.where(rng.random((tile, tile)) < 0.5, 0.25, 0.75)
    g[3] = np.round(g[3] * 4) / 4
    tiles = torch.from_numpy(g)
    for canny_impl, binarize_impl in itertools.product(tmorph.CANNY_IMPLS,
                                                       tmorph.BINARIZE_IMPLS):
        assert not tlanes.otsu_bins_differ(tiles, canny_impl, binarize_impl).any()


@pytest.mark.parametrize("canny_impl,binarize_impl,contour_components", OPTIONS)
def test_kernel_args_carry_the_option_flags(canny_impl, binarize_impl, contour_components):
    gray = torch.zeros(3, 40, 24)
    ints, geo = tlanes.kernel_args(gray, 4, canny_impl, binarize_impl, contour_components)
    assert ints[:4] == (3, 10, 6, 2)
    assert ints[4:7] == (int(canny_impl == "legacy"), int(binarize_impl == "otsu"),
                         int(contour_components))
    # 180 tiles of 4 x 4: 2 a warp, 8 a block, 23 blocks, no shared memory
    assert ints[7:] == (geo.tiles_per_block, geo.grid, int(geo.ws_global), geo.ws_bytes,
                        geo.smem) == (8, 23, 0, 0, 0)


@pytest.mark.parametrize("gray,tile,match", [
    (torch.zeros(2, 16, 16), 3, "power of two"),
    (torch.zeros(1, 2048, 2048), 2048, "power of two"),
    (torch.zeros(2, 16, 20), 8, "whole tiles"),
    (torch.zeros(2, 16, 16, dtype=torch.float64), 4, "float32"),
    (torch.zeros(2, 16, 32)[:, :, ::2], 4, "contiguous"),
    (torch.zeros(16, 16), 4, r"\(B, H, W\)"),
])
def test_kernel_refuses_what_it_does_not_take(gray, tile, match):
    with pytest.raises(ValueError, match=match):
        tlanes.kernel_args(gray, tile, "cv2compat", "adaptive", True)
    if tile > tlanes.MAX_TILE:
        # above the kernel's bound (1024) the CPU op still answers
        assert tlanes.phi_tiles(gray, tile).shape == (1, 1, 1, 8)
    else:
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
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    assert build._source_and_flags("morph_tiles")[0].is_file()
    assert build.library_path("morph_tiles").name.startswith("libmorph_tiles-")


def test_entry_launches_on_the_current_stream_and_raises_on_a_cuda_error(monkeypatch):
    """The launch seam of the three kernels (`build.Entry`): the C function
    gets the device's current raw stream last (or the stream given), the
    device is made current only when it is not, and a nonzero return raises
    RuntimeError naming the kernel.  The C function and torch's CUDA calls
    are stand-ins, so this runs without a card."""
    from mcaq_yolo_tpu_torch.ops import bn_silu
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq

    assert [(e.kernel, e.library, e.symbol) for e in (sq._ENTRY, tlanes._ENTRY, bn_silu._ENTRY)] \
        == [("spatial_quant", "spatial_quant", "mcaq_spatial_quant"),
            ("phi_tiles", "morph_tiles", "mcaq_phi_tiles"), ("bn_silu", "bn_silu", "mcaq_bn_silu")]
    assert all(e.argtypes[-1] is ctypes.c_void_p and e.restype is ctypes.c_int
               for e in (sq._ENTRY, tlanes._ENTRY, bn_silu._ENTRY))
    calls, made_current, rc = [], [], [0]
    entry = build.Entry("some_kernel", "morph_tiles", "mcaq_phi_tiles", [ctypes.c_int])
    entry._fn = lambda *args: calls.append(args) or rc[0]

    class Current:
        def __init__(self, index):
            made_current.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 100 + i, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "device", Current)
    entry.launch(0, 7)
    assert calls == [(7, 100)] and made_current == []
    entry.launch(1, 8, 9)
    entry.launch(1, 8, stream=5)
    assert calls[1:] == [(8, 9, 101), (8, 5)] and made_current == [1, 1]
    rc[0] = 700
    with pytest.raises(RuntimeError, match="^some_kernel kernel launch failed: CUDA error 700$"):
        entry.launch(0, 7)


def test_bound_counts():
    gray = torch.zeros(32, 40, 40)
    assert tlanes.phi_tiles_bytes(gray, 4) == 32 * 40 * 40 * 4 + 32 * 100 * 8 * 4
    full = tlanes.phi_tiles_ops(gray.numel())
    assert full == sum(tlanes.OPS_PER_PIXEL[k] for k in (
        "phi3_sobel", "canny_cv2compat", "binarize_adaptive", "lbp", "contour", "euler",
        "box_counts", "edge_density")) * gray.numel()
    assert tlanes.phi_tiles_ops(gray.numel(), "legacy", "otsu", False) < full
