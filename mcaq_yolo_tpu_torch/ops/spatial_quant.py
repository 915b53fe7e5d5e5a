"""
Fused spatial quantize -> dequantize (x soft mask): the CUDA kernel's
wrapper and its plain PyTorch version.

Port of the TPU kernel `mcaq_yolo_tpu/ops/pallas_quant.py:
spatial_quantize_pallas` (its three pallas_call sites compute one
function).  The kernel is `csrc/spatial_quant.cu`; see its source note for
the design and what bounds it.

  spatial_quantize(x, bit_map, x_min, x_max, mask=None)
      Calls the registered op `torch.ops.mcaq.spatial_quantize`, so eager
      code and a `torch.export` program run the same node: on CUDA tensors
      the op launches the kernel (or raises: there is no fallback), on CPU
      tensors it runs the plain version.
  spatial_quantize_torch(...)
      The same function in plain PyTorch, the arithmetic of the reference's
      `_compose_integer` (`core/quantization.py:421-460`) in the same
      literal order, so the kernel is held to it bitwise.

x is (B, H, W, C) NHWC-contiguous, float32 or bfloat16; bit_map (B, Ht, Wt)
float32; x_min / x_max (C,) float32, one range per channel, or (7, C) /
(7, 1), one row per bit width 2..8 (the reference's mse calibration, whose
7-plane compose, `quantization.py:439-449`, quantizes each tile with its
bit width's row: per element the same arithmetic as `quantize_tensor`);
mask (B, H, W) or (B, H, W, 1) float32.  The kernel moves 16 bytes of
channels per thread, so on CUDA C is
a multiple of 4 (float32) or 8 (bfloat16) and x is 16-byte aligned, as every
YOLOv8 variant's C3/C4/C5 map is, and pixel indices fit 32 bits (B*H*W,
H*Ht, W*Wt < 2^31); it raises otherwise.  Math in float32,
output in x's dtype.  Tile of pixel (h, w) is
(floor(h * Ht / H), floor(w * Wt / W)) — the reference model path's rule;
the Pallas kernel clamps remainder pixels into the last tile instead, and
the two agree on exact tile multiples.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..core import image_ops as iops
from .build import Entry

MIN_BITS, MAX_BITS = 2, 8
N_BITS = MAX_BITS - MIN_BITS + 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's block: THREADS threads (kThreads in csrc/spatial_quant.cu),
# taking SPAN 16-byte groups per pass, 3 per thread (kSpan)
THREADS = 128
SPAN = THREADS * 3
_INT32_LIMIT = 2 ** 31


class Geometry(NamedTuple):
    """The kernel's launch geometry for one map shape and dtype."""
    vec: int            # channels per 16-byte group (4 float32, 8 bfloat16)
    groups: int         # 16-byte groups per pixel, G = C / vec
    pix_per_block: int  # pixels per block: a contiguous run of x and of the output
    blocks: int         # ceil(B * H * W / pix_per_block)
    magic: int          # group j of a block lies in pixel (j * magic) >> shift
    shift: int          # of the block's run


def div_magic(d: int, bound: int):
    """(magic, shift) with (j * magic) >> shift == j // d for 0 <= j < bound,
    magic < 2^32: magic 1 and shift log2(d) when d is a power of two.

    With magic = ceil(2^s / d) and e = magic * d - 2^s (0 <= e < d),
    j * magic / 2^s = j / d + j * e / (d * 2^s), which floors to j // d
    whenever (bound - 1) * e < 2^s; the smallest such s is taken."""
    if d < 1 or bound < 1:
        raise ValueError(f"div_magic: d={d}, bound={bound}")
    for s in range(64):
        m = -(-(1 << s) // d)
        e = m * d - (1 << s)
        if m < 2 ** 32 and (bound - 1) * e < (1 << s):
            return m, s
    raise ValueError(f"div_magic: no 32-bit multiplier for d={d}, bound={bound}")


@functools.lru_cache(maxsize=256)
def launch_geometry(B: int, H: int, W: int, C: int, elem_size: int) -> Geometry:
    """Launch geometry of the kernel for a (B, H, W, C) map of `elem_size`
    bytes per element: each block owns the run of whole pixels whose 16-byte
    groups fit one pass of SPAN groups (one pixel when a pixel alone has
    more; the block then takes it in several passes)."""
    vec = 16 // elem_size
    if C % vec:
        raise ValueError(f"launch_geometry: C={C} is not a multiple of {vec}")
    groups = C // vec
    ppb = max(1, SPAN // groups)
    magic, shift = div_magic(groups, ppb * groups)
    return Geometry(vec, groups, ppb, -(-(B * H * W) // ppb), magic, shift)


def precompute_qparams(x_min: torch.Tensor, x_max: torch.Tensor):
    """Per-(bit, channel) tables (scale, inv_scale, zp), each (7, C) float32
    (reference `pallas_quant.py:92-101`); row i is bit width i + 2.  The
    kernel's table kernel writes (scale, zp) with these formulas, and its
    quantize kernel gathers them by each pixel's bit width."""
    half = torch.tensor([2.0 ** (b - 1) for b in range(MIN_BITS, MAX_BITS + 1)],
                        dtype=torch.float32, device=x_min.device)[:, None]
    qmin = -half
    d = 2.0 * half - 1.0
    x_range = torch.clamp(x_max - x_min, min=1e-8)[None]
    scale = x_range / d
    zp = torch.clamp(qmin - x_min[None] / scale, qmin, qmin + d)
    return scale, 1.0 / scale, zp


def spatial_quantize_torch(x: torch.Tensor, bit_map: torch.Tensor,
                           x_min: torch.Tensor, x_max: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    B, H, W, C = x.shape
    bits_r = torch.clamp(torch.round(bit_map.to(torch.float32)), MIN_BITS, MAX_BITS)
    b_pix = iops.upsample_nearest(bits_r, (H, W))[..., None]        # (B, H, W, 1)
    half = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=x.device),
        (b_pix - 1.0).to(torch.int32)).to(torch.float32)            # 2^(b-1), exact
    qmin = -half
    d = 2.0 * half - 1.0
    qmax = qmin + d
    if x_min.dim() == 2:  # per-bit rows: each pixel takes its bit width's row
        row = (b_pix[..., 0] - MIN_BITS).to(torch.long)             # (B, H, W)
        x_min, x_max = x_min[row], x_max[row]                       # (B, H, W, C or 1)
    x_range = torch.clamp(x_max - x_min, min=1e-8)
    scale = x_range / d
    zp = torch.clamp(qmin - x_min / scale, qmin, qmax)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale + zp), qmin, qmax)
    out = (q - zp) * scale
    if mask is not None:
        out = out * mask.reshape(B, H, W, 1)
    return out.to(x.dtype)


def _check(x, bit_map, x_min, x_max, mask):
    """Refuse what the kernel does not take; return (B, H, W, C, Ht, Wt)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"spatial_quantize: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("spatial_quantize: x must be a contiguous (B, H, W, C) NHWC "
                         f"tensor, got shape {tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    if bit_map.dim() != 3 or bit_map.shape[0] != B:
        raise ValueError(f"spatial_quantize: bit_map must be (B, Ht, Wt), got "
                         f"{tuple(bit_map.shape)}")
    named = [("bit_map", bit_map), ("x_min", x_min), ("x_max", x_max)]
    if mask is not None:
        if mask.numel() != B * H * W or mask.shape[:3] != (B, H, W):
            raise ValueError(f"spatial_quantize: mask must be (B, H, W[, 1]), got "
                             f"{tuple(mask.shape)}")
        named.append(("mask", mask))
    dev = x.device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"spatial_quantize: {name} on {t.device}, x on {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"spatial_quantize: {name} must be contiguous float32")
    if x_min.shape != x_max.shape or x_min.shape not in ((C,), (N_BITS, C)):
        raise ValueError(f"spatial_quantize: x_min/x_max must be ({C},) or ({N_BITS}, {C}), "
                         f"got {tuple(x_min.shape)} / {tuple(x_max.shape)}")
    _, Ht, Wt = bit_map.shape
    if max(B * H * W, H * Ht, W * Wt, N_BITS * C) >= _INT32_LIMIT:
        raise ValueError("spatial_quantize: the kernel indexes pixels and tiles in 32 bits; "
                         f"B*H*W={B * H * W}, H*Ht={H * Ht}, W*Wt={W * Wt} must stay "
                         "below 2^31")
    vec = 16 // x.element_size()
    if C % vec or x.data_ptr() % 16:
        raise ValueError(f"spatial_quantize: the kernel moves 16 bytes ({vec} channels) "
                         f"per thread; C={C} must be a multiple of {vec} and x 16-byte "
                         "aligned")
    return B, H, W, C, Ht, Wt


# the kernel's C entry and its occupancy query (csrc/spatial_quant.cu)
_ENTRY = Entry("spatial_quant", "spatial_quant", "mcaq_spatial_quant",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
               + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
_BLOCKS_PER_SM = Entry("spatial_quant", "spatial_quant", "mcaq_spatial_quant_blocks_per_sm",
                       [ctypes.c_int])


def blocks_per_sm(dtype: torch.dtype) -> int:
    """Blocks of the quantize kernel resident on one SM at once (CUDA's
    occupancy calculator), for counting a launch's waves.  Needs CUDA."""
    n = _BLOCKS_PER_SM.fn()(_DTYPE_CODE[dtype])
    if n < 1:
        raise RuntimeError("spatial_quant: the occupancy query failed")
    return n


def _launch(x: torch.Tensor, bit_map: torch.Tensor, x_min: torch.Tensor,
            x_max: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, launches, counts the launch."""
    B, H, W, C, Ht, Wt = _check(x, bit_map, x_min, x_max, mask)
    geo = launch_geometry(B, H, W, C, x.element_size())
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    index = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    # scratch for the per-(bit, channel) scale and zero-point table that the
    # kernel's first launch writes, from the caching allocator without a
    # tensor around it (a few µs less per call than torch.empty): freed on
    # return, handed out again only to work queued after this call on the
    # stream
    table = torch.cuda.caching_allocator_alloc(2 * N_BITS * C * 4, index, stream)
    try:
        _ENTRY.launch(index, x.data_ptr(), bit_map.data_ptr(), x_min.data_ptr(),
                      x_max.data_ptr(), mask.data_ptr() if mask is not None else None, table,
                      out.data_ptr(), _DTYPE_CODE[x.dtype], B, H, W, C, Ht, Wt,
                      C if x_min.dim() == 2 else 0, geo.pix_per_block, geo.magic, geo.shift,
                      stream=stream)
    finally:
        torch.cuda.caching_allocator_delete(table)
    spatial_quantize.launches += 1
    return out


# The kernel as a registered op: the plain version on the CPU, the kernel on
# CUDA, an empty NHWC-contiguous tensor of x's shape and dtype while a program
# is traced (torch.export), so an exported program carries the op as a node.
@torch.library.custom_op("mcaq::spatial_quantize", mutates_args=(), device_types="cpu")
def _spatial_quantize_op(x: torch.Tensor, bit_map: torch.Tensor, x_min: torch.Tensor,
                         x_max: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return spatial_quantize_torch(x, bit_map, x_min, x_max, mask)


_spatial_quantize_op.register_kernel("cuda")(_launch)


@_spatial_quantize_op.register_fake
def _(x, bit_map, x_min, x_max, mask):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def spatial_quantize(x: torch.Tensor, bit_map: torch.Tensor, x_min: torch.Tensor,
                     x_max: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused kernel on CUDA tensors; the plain version on CPU tensors;
    through the registered op `mcaq::spatial_quantize` either way.  Per-bit
    ranges of shape (7, 1) are expanded to a contiguous (7, C) here.

    `spatial_quantize.launches` counts kernel launches (and nothing else)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spatial_quantize: unsupported device {x.device}")
    if x_min.dim() == 2 and x_min.shape[1] == 1:
        C = x.shape[-1]
        x_min = x_min.expand(N_BITS, C).contiguous()
        x_max = x_max.expand(N_BITS, C).contiguous()
    return torch.ops.mcaq.spatial_quantize(x, bit_map, x_min, x_max, mask)


spatial_quantize.launches = 0
