"""The training quantize's kernel pair (`csrc/frac_quant.cu`,
`ops/frac_quant.py`) as far as the CPU can hold it.

The kernels run only on a GPU (their tests on the card are in
`tests/test_torch_gpu.py`), so here:
  * `frac_quant_backward_torch`, the kernel's backward arithmetic in plain
    PyTorch, against autograd through `compose_fractional` x mask: grad x
    bitwise, grad frac and grad mask within 1e-5 relative L2 (the sums run
    in another order), at C 64, 192 and 6, in float32 and bfloat16, with
    and without the mask, with bits at exactly 2.0 and 8.0 and fractional,
    on a non-multiple tile grid and with mse's per-bit rows;
  * `frac_quantize` on CPU tensors is the plain path, value and gradients,
    and launches (counts) nothing; so is the quantizer's training branch;
  * a plain-Python mirror of the kernels' (block, thread) -> (tile, pixel,
    channel group) mapping visits every element once, in the tile that
    `upsample_nearest` gives its pixel, for the geometry `geometry` picks;
  * `geometry` over every YOLOv8 and YOLO11 width;
  * the build flags (no FMA contraction) and each C entry's argtypes
    against its signature in the source.
Nothing here needs jax."""

import numpy as np
import pytest
import torch

from mcaq_yolo_tpu_torch.core import image_ops as iops
from mcaq_yolo_tpu_torch.core.quantization import (SpatialAdaptiveQuantization,
                                                   calibrate_mse, compose_fractional)
from mcaq_yolo_tpu_torch.models.yolo import VARIANTS, variant_channels
from mcaq_yolo_tpu_torch.ops import frac_quant as fq
from mcaq_yolo_tpu_torch.utils import profiling


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _case(B, H, W, C, Ht, Wt, dtype, bits_kind, mse, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, H, W, C, generator=g) * 1.5 + 0.2).to(dtype)
    if bits_kind == "fractional":
        bits = torch.rand(B, Ht, Wt, generator=g) * 6.0 + 2.0
    else:   # exactly 2.0 and 8.0 (the top's ceil is itself), and 5.0
        bits = torch.tensor([2.0, 8.0, 5.0])[torch.randint(0, 3, (B, Ht, Wt), generator=g)]
    xf = x.float()
    if mse:
        lo, hi = calibrate_mse(xf)
    else:
        lo, hi = torch.aminmax(xf.reshape(-1, C), dim=0)
    mask = torch.rand(B, H, W, 1, generator=g)
    up = torch.randn(B, H, W, C, generator=g).to(dtype)
    return x, bits, lo.contiguous(), hi.contiguous(), mask, up


CASES = [
    # (B, H, W, C, Ht, Wt), dtype, bits, mse
    ((2, 16, 16, 64, 2, 2), torch.float32, "fractional", False),
    ((2, 16, 16, 64, 2, 2), torch.bfloat16, "integer", False),
    ((1, 16, 16, 192, 2, 2), torch.bfloat16, "fractional", False),   # yolov8m P3's width
    ((1, 16, 16, 192, 2, 2), torch.float32, "integer", True),
    ((2, 8, 8, 6, 2, 2), torch.float32, "fractional", True),         # odd C: element by element
    ((2, 8, 8, 6, 2, 2), torch.bfloat16, "integer", False),
    ((3, 12, 10, 64, 5, 3), torch.bfloat16, "fractional", False),    # non-multiple tiles
    ((2, 12, 12, 6, 5, 5), torch.float32, "integer", False),
]


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("shape,dtype,bits_kind,mse", CASES)
def test_backward_torch_matches_autograd(shape, dtype, bits_kind, mse, with_mask):
    x, bits, lo, hi, mask, up = _case(*shape, dtype, bits_kind, mse, seed=sum(shape))
    m = mask.clone().requires_grad_(True) if with_mask else None
    xt, bt = x.clone().requires_grad_(True), bits.clone().requires_grad_(True)
    out = compose_fractional(xt.to(torch.float32), bt, lo, hi)
    if with_mask:
        out = out * m
    out.to(dtype).backward(up)

    gx, gb, gm = fq.frac_quant_backward_torch(x, up, bits, lo, hi, mask if with_mask else None)
    assert gx.dtype == dtype and torch.equal(gx, xt.grad)
    assert gb.shape == bits.shape and _rel_l2(gb, bt.grad) <= 1e-5
    assert float(bt.grad.abs().max()) > 0
    if with_mask:
        assert gm.shape == mask.shape and _rel_l2(gm, m.grad) <= 1e-5
    else:
        assert gm is None


def test_backward_torch_gives_zero_outside_two_to_eight():
    """A tile whose floor(bit) is not one of 2..8 takes no compose term:
    its output and every gradient through it are 0, as the one-hot sum's."""
    x, bits, lo, hi, mask, up = _case(1, 8, 8, 8, 2, 2, torch.float32, "fractional", False, 3)
    bits[0, 0, 0], bits[0, 1, 1] = 1.5, 9.25
    xt, bt = x.clone().requires_grad_(True), bits.clone().requires_grad_(True)
    (compose_fractional(xt, bt, lo, hi) * mask).backward(up)
    gx, gb, gm = fq.frac_quant_backward_torch(x, up, bits, lo, hi, mask)
    assert torch.equal(gx, xt.grad)
    assert float(gx[0, :4, :4].abs().max()) == 0 and float(gx[0, 4:, 4:].abs().max()) == 0
    assert float(gb[0, 0, 0]) == 0 == float(gb[0, 1, 1]) and float(bt.grad[0, 0, 0]) == 0
    assert float(gm[0, :4, :4].abs().max()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mask", [True, False])
def test_wrapper_on_cpu_is_the_plain_path_and_counts_nothing(dtype, with_mask):
    x, bits, lo, hi, mask, up = _case(2, 16, 16, 64, 2, 2, dtype, "fractional", False, 11)
    runs = []
    for fn in (fq.frac_quantize, fq.frac_quantize_torch):
        xt, bt = x.clone().requires_grad_(True), bits.clone().requires_grad_(True)
        m = mask.clone().requires_grad_(True) if with_mask else None
        before = profiling.counters().get("frac_quant", 0)
        out = fn(xt, bt, lo, hi, m)
        out.backward(up)
        assert profiling.counters().get("frac_quant", 0) == before
        runs.append((out.detach(), xt.grad, bt.grad, m.grad if with_mask else None))
    (a, ax, ab, am), (b, bx, bb, bm) = runs
    assert a.dtype == dtype and torch.equal(a, b)
    assert torch.equal(ax, bx) and torch.equal(ab, bb)
    assert (am is None and bm is None) or torch.equal(am, bm)
    ref = compose_fractional(x.float(), bits, lo, hi)
    assert torch.equal(b, (ref * mask if with_mask else ref).to(dtype))


def test_wrapper_refuses_another_device():
    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fq.frac_quantize(x, torch.zeros(1, 1, 1, device="meta"), torch.zeros(8, device="meta"),
                         torch.ones(8, device="meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["minmax", "mse"])
def test_quantizer_training_branch_keeps_its_cpu_arithmetic(dtype, mode):
    """The quantizer's training forward on the CPU is compose_fractional on
    x in float32, times the soft mask of that x, cast back: value and the
    gradients to x, the bit map and the mask's weights."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(2, 16, 16, 64, generator=g) * 2).to(dtype)
    bits = torch.rand(2, 2, 2, generator=g) * 6 + 2
    up = torch.randn(2, 16, 16, 64, generator=g).to(dtype)
    q = SpatialAdaptiveQuantization(64, calibration_mode=mode)
    q.soft_mask.init_weights(torch.Generator().manual_seed(0))
    runs = []
    for plain in (False, True):
        q.running_min.zero_(), q.running_max.zero_(), q.num_batches.zero_()
        q.zero_grad()
        xt, bt = x.clone().requires_grad_(True), bits.clone().requires_grad_(True)
        if plain:
            q.ema_update(xt)
            xf = xt.to(torch.float32)
            lo, hi = q.calibration_range(xf, training=True)
            out = (compose_fractional(xf, bt, lo, hi) * q.soft_mask(bt, xf)).to(dtype)
        else:
            out = q(xt, bt, training=True)
        out.backward(up)
        runs.append([out.detach(), xt.grad, bt.grad]
                    + [p.grad.clone() for p in q.soft_mask.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _kernel_visits(B, H, W, C, Ht, Wt, geo):
    """A plain-Python mirror of the kernels' mapping: for each block (one a
    tile) and thread, the (pixel, channel) elements it touches, with the
    block's tile; returns visits per element and the tile of each pixel."""
    vec, lanes, threads = geo
    visits = np.zeros((B, H, W, C), np.int64)
    tile_of_pixel = np.full((B, H, W), -1, np.int64)
    per_lane = C // vec // lanes
    slots = threads // lanes
    for block in range(B * Ht * Wt):
        tw, th, b = block % Wt, (block // Wt) % Ht, block // (Wt * Ht)
        h0, h1 = (th * H + Ht - 1) // Ht, ((th + 1) * H + Ht - 1) // Ht
        w0, w1 = (tw * W + Wt - 1) // Wt, ((tw + 1) * W + Wt - 1) // Wt
        nw, npix = w1 - w0, (h1 - h0) * (w1 - w0)
        for t in range(threads):
            lane = t % lanes
            for p in range(t // lanes, npix, slots):
                h, w = h0 + p // nw, w0 + p % nw
                tile_of_pixel[b, h, w] = th * Wt + tw
                for j in range(per_lane):
                    c0 = (lane + j * lanes) * vec
                    visits[b, h, w, c0:c0 + vec] += 1
    return visits, tile_of_pixel


@pytest.mark.parametrize("shape", [(2, 16, 16, 64, 2, 2), (1, 16, 16, 192, 2, 2),
                                   (1, 8, 8, 384, 2, 2), (1, 8, 8, 576, 2, 2),
                                   (2, 12, 10, 24, 5, 3), (1, 3, 7, 6, 5, 2),
                                   (1, 9, 9, 85, 2, 4)])
@pytest.mark.parametrize("elem_size,aligned", [(2, True), (4, True), (2, False)])
def test_kernel_mapping_covers_each_element_once_in_its_tile(shape, elem_size, aligned):
    B, H, W, C, Ht, Wt = shape
    geo = fq.geometry(C, elem_size, aligned, -(-H // Ht) * -(-W // Wt))
    assert C % (geo.vec * geo.lanes) == 0 and geo.threads % 32 == 0
    visits, tiles = _kernel_visits(B, H, W, C, Ht, Wt, geo)
    assert (visits == 1).all()
    ti = torch.arange(Ht * Wt, dtype=torch.float32).reshape(1, Ht, Wt).expand(B, Ht, Wt)
    expect = iops.upsample_nearest(ti, (H, W)).numpy().astype(np.int64)
    np.testing.assert_array_equal(tiles, expect)


def test_geometry_over_every_variant_width():
    """bf16 under autocast at 640 px, ds 1: P3 tiles of 8 x 8, P4 and P5 4 x 4.
    YOLOv8m's three widths take 8 / 16 / 8 lanes, 3 / 3 / 9 groups a lane,
    128 threads; every width fills 16-byte groups."""
    tiles = (64, 16, 16)
    for name in VARIANTS:
        for C, pix in zip(variant_channels(name), tiles):
            for elem in (2, 4):
                vec, lanes, threads = fq.geometry(C, elem, True, pix)
                assert vec == 16 // elem and (C // vec) % lanes == 0
                assert lanes in (1, 2, 4, 8, 16, 32) and 32 <= threads <= fq.MAX_THREADS
    got = [fq.geometry(C, 2, True, p) for C, p in zip((192, 384, 576), tiles)]
    assert got == [(8, 8, 128), (8, 16, 128), (8, 8, 128)]
    assert fq.geometry(6, 4, True, 16) == (1, 2, 32)     # odd C: element by element
    assert fq.geometry(64, 2, False, 64) == (1, 32, 128)  # unaligned: element by element


@pytest.mark.parametrize("entry", ["_FORWARD", "_BACKWARD"])
def test_kernel_build_flags_and_entries_match_the_source(entry):
    """Built with the others, without FMA contraction (the forward and grad
    x are held bitwise to the plain path); each C entry's argtypes are its
    signature in csrc/frac_quant.cu, parameter by parameter, so ctypes
    passes every pointer as a pointer and every int as an int."""
    import ctypes
    import re

    from mcaq_yolo_tpu_torch.ops import build

    assert "frac_quant" in build.KERNELS
    assert "--fmad=false" in build.nvcc_flags("frac_quant")
    src, _ = build._source_and_flags("frac_quant")
    e = getattr(fq, entry)
    m = re.search(r'extern "C" int ' + e.symbol + r"\(([^)]*)\)", src.read_text())
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all(p.startswith(("const void*", "void*", "int ")) for p in params)
    assert e.argtypes == kinds and e.restype is ctypes.c_int
