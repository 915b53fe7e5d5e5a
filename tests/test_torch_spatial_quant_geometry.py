"""The CUDA kernel's launch geometry and its decomposition, on the CPU.

The kernel (`mcaq_yolo_tpu_torch/csrc/spatial_quant.cu`) runs only on a
GPU, so what surrounds it is held here:
  * `div_magic`: (j * magic) >> shift == j // G for every j a block takes,
    with magic < 2^32 and a plain shift for powers of two;
  * `launch_geometry` over many shapes, every YOLOv8 variant's widths at
    640 px among them: each block's run of whole pixels fits one pass of
    SPAN groups (or is one pixel), and the blocks cover the map;
  * a plain-Python mirror of the kernel's (block, thread, pass) -> (pixel,
    channel group) -> tile mapping visits every 16-byte group exactly once,
    at the address the kernel reads, in the tile that `upsample_nearest`
    gives the pixel (floor(h * Ht / H), floor(w * Wt / W));
  * gathering `precompute_qparams`' (bit, channel) table by each pixel's
    bit width reproduces `spatial_quantize_torch` bitwise — the
    decomposition the kernel's two launches rely on — on random and edge
    inputs, in float32 and bfloat16, with and without the mask.
Nothing here needs jax."""

import math

import numpy as np
import pytest
import torch

from mcaq_yolo_tpu_torch.core import image_ops as iops
from mcaq_yolo_tpu_torch.models.yolo import VARIANTS, _ch
from mcaq_yolo_tpu_torch.ops import spatial_quant as sq


def _variant_widths():
    """(variant, scale, H, C) of every YOLOv8 variant's C3 / C4 / C5 at 640 px."""
    out = []
    for name, (_, w, mc) in VARIANTS.items():
        if not name.startswith("yolov8"):
            continue
        for scale, (h, base) in zip(("P3", "P4", "P5"), ((80, 256), (40, 512), (20, 1024))):
            out.append((name, scale, h, _ch(base, w, mc)))
    return out


VARIANT_WIDTHS = _variant_widths()


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 8, 12, 16, 24, 32, 40, 48, 72, 80, 96, 144,
                               160, 257, 384, 514, 1000])
def test_div_magic_divides_exactly(d):
    for bound in sorted({1, d, 2 * d, max(1, sq.SPAN // d) * d, 5000}):
        magic, shift = sq.div_magic(d, bound)
        assert 1 <= magic < 2 ** 32 and 0 <= shift < 64
        if d & (d - 1) == 0 and bound > 1:  # a plain shift
            assert (magic, shift) == (1, int(math.log2(d)))
        j = np.arange(bound, dtype=np.uint64)
        got = (j * np.uint64(magic)) >> np.uint64(shift)
        np.testing.assert_array_equal(got, j // np.uint64(d))


def test_div_magic_refuses_nonsense():
    with pytest.raises(ValueError):
        sq.div_magic(0, 10)


def _geometry_cases():
    cases = [(1, h, h, c, e) for _, _, h, c in VARIANT_WIDTHS for e in (2, 4)]
    cases += [(3, 12, 12, 24, 4), (2, 13, 7, 8, 2), (1, 5, 9, 2056, 4), (1, 3, 3, 8192, 2),
              (256, 80, 80, 64, 2), (7, 33, 17, 40, 2)]
    return cases


@pytest.mark.parametrize("B,H,W,C,elem", _geometry_cases())
def test_launch_geometry_covers_the_map(B, H, W, C, elem):
    geo = sq.launch_geometry(B, H, W, C, elem)
    assert geo.vec == 16 // elem and geo.groups * geo.vec == C
    assert geo.pix_per_block >= 1
    assert geo.pix_per_block * geo.groups <= sq.SPAN or geo.pix_per_block == 1
    # the largest run of whole pixels that fits one pass
    assert geo.pix_per_block == max(1, sq.SPAN // geo.groups)
    n_pix = B * H * W
    assert (geo.blocks - 1) * geo.pix_per_block < n_pix <= geo.blocks * geo.pix_per_block
    j = np.arange(geo.pix_per_block * geo.groups, dtype=np.uint64)
    np.testing.assert_array_equal((j * np.uint64(geo.magic)) >> np.uint64(geo.shift),
                                  j // np.uint64(geo.groups))


def test_launch_geometry_refuses_a_partial_group():
    with pytest.raises(ValueError, match="multiple"):
        sq.launch_geometry(1, 4, 4, 12, 2)  # bf16 moves 8 channels per group


def kernel_mapping(B, H, W, C, Ht, Wt, elem):
    """Mirror of spatial_quant_kernel's indexing, thread by thread: for every
    16-byte group a thread takes, (offset of the group in x, in elements;
    pixel; first channel; tile row; tile column; batch)."""
    geo = sq.launch_geometry(B, H, W, C, elem)
    G, vec, ppb = geo.groups, geo.vec, geo.pix_per_block
    n_pix = B * H * W
    rows = []
    tid = np.arange(sq.THREADS)
    for block in range(geo.blocks):
        p0 = block * ppb
        npb = min(ppb, n_pix - p0)
        n = npb * G
        # the block's per-pixel set-up: (b, h, w) and tile of each pixel
        pix = p0 + np.arange(npb)
        row = pix // W
        w = pix - row * W
        b = row // H
        h = row - b * H
        th, tw = h * Ht // H, w * Wt // W
        for j0 in range(0, n, sq.SPAN):  # passes
            end = min(n, j0 + sq.SPAN)
            for start in range(j0, end, sq.THREADS):  # each thread's loop
                j = start + tid
                j = j[j < end]
                p = ((j.astype(np.uint64) * np.uint64(geo.magic)) >> np.uint64(geo.shift))
                p = p.astype(np.int64)
                c0 = (j - p * G) * vec
                rows.append(np.stack([p0 * C + j * vec, pix[p], c0, th[p], tw[p], b[p]], 1))
    return np.concatenate(rows)


def _mapping_cases():
    cases = [(1, h, h, c, t, t, e) for _, _, h, c in VARIANT_WIDTHS
             for t in ((10,) if h > 20 else (5,)) for e in (2, 4)]
    cases += [(3, 12, 12, 24, 5, 5, 4), (2, 13, 7, 8, 4, 3, 2), (2, 9, 11, 16, 9, 11, 4),
              (1, 5, 9, 2056, 2, 3, 4), (2, 7, 5, 24, 1, 1, 2)]
    return cases


@pytest.mark.parametrize("B,H,W,C,Ht,Wt,elem", _mapping_cases())
def test_kernel_mapping_hits_each_group_once_in_its_tile(B, H, W, C, Ht, Wt, elem):
    m = kernel_mapping(B, H, W, C, Ht, Wt, elem)
    offset, pix, c0, th, tw, b = m.T
    vec = 16 // elem
    # every group exactly once, at the address of its (pixel, channel)
    assert len(m) == B * H * W * C // vec
    np.testing.assert_array_equal(np.sort(offset), np.arange(0, B * H * W * C, vec))
    np.testing.assert_array_equal(offset, pix * C + c0)
    assert c0.min() >= 0 and c0.max() < C and (c0 % vec == 0).all()
    # the tile of each pixel is the one upsample_nearest gives it
    tiles = torch.arange(B * Ht * Wt, dtype=torch.float64).reshape(B, Ht, Wt)
    want = iops.upsample_nearest(tiles, (H, W)).reshape(-1).numpy().astype(np.int64)
    np.testing.assert_array_equal((b * Ht + th) * Wt + tw, want[pix])


def _table_gather(x, bit_map, x_min, x_max, mask=None):
    """The kernel's decomposition in plain PyTorch: the (7, C) table of
    precompute_qparams, gathered by each pixel's rounded bit width."""
    B, H, W, C = x.shape
    scale_t, _, zp_t = sq.precompute_qparams(x_min, x_max)
    bits = torch.clamp(torch.round(bit_map), sq.MIN_BITS, sq.MAX_BITS)
    bi = iops.upsample_nearest(bits, (H, W)).to(torch.int64) - sq.MIN_BITS   # (B, H, W)
    scale, zp = scale_t[bi], zp_t[bi]                                          # (B, H, W, C)
    half = torch.ldexp(torch.ones_like(bi, dtype=torch.float32), bi + 1)[..., None]
    qmin = -half
    qmax = qmin + (2.0 * half - 1.0)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale + zp), qmin, qmax)
    out = (q - zp) * scale
    if mask is not None:
        out = out * mask.reshape(B, H, W, 1)
    return out.to(x.dtype)


def _decomposition_inputs(kind, seed):
    rng = np.random.default_rng(seed)
    B, H, W, C, Ht, Wt = (2, 12, 12, 24, 5, 5) if kind == "non-multiple" else (2, 16, 16, 16, 4, 4)
    x = rng.normal(0, 1, (B, H, W, C))
    bit_map = rng.uniform(1.5, 8.5, (B, Ht, Wt))
    rng_ = None
    if kind == "constant":
        x[..., :4] = [0.75, -3.0, 0.0, 1e-30]
    elif kind == "subnormal":
        x = x * 1e-39
        x[0, 0, 0, : C // 2] = 1.0
    elif kind == "large":
        x = x * 1e36
    elif kind == "overflow":
        x = x * 1e37
        rng_ = (np.full(C, -0.01), np.full(C, 0.01))
    elif kind == "ties":
        bit_map = rng.integers(1, 9, (B, Ht, Wt)) + 0.5
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    mask = t(rng.uniform(0.0, 1.0, (B, H, W)))
    return t(x), t(bit_map), mask, (None if rng_ is None else tuple(map(t, rng_)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "non-multiple", "constant", "subnormal", "large",
                                  "overflow", "ties"])
def test_table_gather_equals_plain_bitwise(kind, dtype):
    x32, bit_map, mask, rng = _decomposition_inputs(kind, seed=len(kind))
    x = x32.to(dtype)
    if rng is None:
        lo, hi = torch.aminmax(x.reshape(-1, x.shape[-1]).to(torch.float32), dim=0)
    else:
        lo, hi = rng
    ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for m in (None, mask):
        want = sq.spatial_quantize_torch(x, bit_map, lo, hi, m)
        got = _table_gather(x, bit_map, lo, hi, m)
        assert torch.isfinite(want).all()
        assert torch.equal(got.view(ibits), want.view(ibits))


def test_check_refuses_32_bit_overflow():
    """The kernel indexes pixels and tiles in 32 bits; the wrapper refuses
    a map beyond that before any launch (meta tensors: nothing allocated)."""
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty((2 ** 15, 2 ** 8, 2 ** 8, 8), **meta)
    with pytest.raises(ValueError, match="32 bits"):
        sq._check(x, torch.empty((2 ** 15, 4, 4), **meta), torch.empty(8, **meta),
                  torch.empty(8, **meta), None)
