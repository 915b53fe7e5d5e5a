"""
The training quantize of the MCAQ transform, forward and backward: the CUDA
kernel pair's wrapper, the plain PyTorch path it stands in for, and the
plain version of the kernel's backward arithmetic.

The kernels are `csrc/frac_quant.cu`; see its source note for the design
and what bounds it.  They replace no TPU kernel: the JAX package runs this
compose in XLA.

  frac_quantize(x, bit_map, x_min, x_max, mask=None)
      ((1 - f) Q_floor(x) + f Q_ceil(x)) [* mask], in x's dtype, per tile of
      the continuous bit map (f = bit - floor(bit)), with the straight-through
      estimator's gradient to x and the gradients to the bit map and the
      mask.  On CUDA tensors a `torch.autograd.Function` whose forward and
      backward are one kernel launch each (or it raises: there is no
      fallback); on CPU tensors `frac_quantize_torch`, autograd through the
      plain ops.
  frac_quantize_torch(...)
      The plain path: `core/quantization.py:compose_fractional` on x in
      float32, times the mask, cast back to x's dtype.
  frac_quant_backward_torch(x, g, bit_map, x_min, x_max, mask=None)
      The kernel's backward arithmetic in plain PyTorch, (grad_x, grad_bit_map,
      grad_mask): the yardstick the kernel is held to.  grad_x is autograd's
      through the plain path bit for bit; the two sums agree with autograd's
      to rounding (another order).

x is (B, H, W, C) NHWC-contiguous, float32 or bfloat16; bit_map (B, Ht, Wt)
float32, continuous; x_min / x_max float32, (C,) one range per channel or
(7, C) / (7, 1) one row per bit width 2..8 (mse calibration); mask (B, H,
W, 1) or (B, H, W) float32 (the soft mask) or None.  Tile of pixel (h, w):
(floor(h * Ht / H), floor(w * Wt / W)), `core/image_ops.py:
upsample_nearest`'s rule.  On CUDA a map whose C fills 16-byte groups (a
multiple of 4 float32 or 8 bfloat16 channels) at 16-byte aligned addresses
moves whole groups, any other element by element (`geometry`).  Every
launch, forward or backward, adds one to the program's counter
`frac_quant` (`utils/profiling.py:count`), in the spans open on the thread
that ran the forward (the backward runs on autograd's worker thread).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from ..core import image_ops as iops
from ..utils.profiling import count, counters, span_stack
from .build import Entry

MIN_BITS, MAX_BITS = 2, 8
N_BITS = MAX_BITS - MIN_BITS + 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_THREADS = 128  # kMaxThreads in csrc/frac_quant.cu: a tile's block
_INT32_LIMIT = 2 ** 31 - 1


class Geometry(NamedTuple):
    """How the kernels cut one map: each block owns one tile."""
    vec: int      # elements a group: 16 bytes' worth (4 float32, 8 bfloat16), or 1
    lanes: int    # lanes a pixel: the largest power of two <= 32 dividing C / vec
    threads: int  # threads a block: lanes x the tile's pixels, in warps, at most 128


def geometry(C: int, elem_size: int, aligned: bool, tile_pixels: int) -> Geometry:
    """The kernels' geometry for C channels of `elem_size` bytes, whether
    every pointer is 16-byte aligned, and the largest tile's pixels."""
    group = 16 // elem_size
    vec = group if aligned and C % group == 0 else 1
    groups = C // vec
    lanes = min(groups & -groups, 32)
    threads = min(MAX_THREADS, -(-lanes * tile_pixels // 32) * 32)
    return Geometry(vec, lanes, threads)


def launches() -> int:
    """The kernels' launches so far in this process (the counter `frac_quant`)."""
    return counters().get("frac_quant", 0)


def frac_quantize_torch(x: torch.Tensor, bit_map: torch.Tensor, x_min: torch.Tensor,
                        x_max: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain path (any device), autograd through the plain ops."""
    # imported here: core/quantization.py imports this module
    from ..core.quantization import compose_fractional

    x_q = compose_fractional(x.to(torch.float32), bit_map, x_min, x_max)
    if mask is not None:
        x_q = x_q * mask
    return x_q.to(x.dtype)


def _tile_sum(per_pixel: torch.Tensor, Ht: int, Wt: int) -> torch.Tensor:
    """(B, H, W) -> (B, Ht, Wt): each tile's sum, by upsample_nearest's rule."""
    B, H, W = per_pixel.shape
    ri = torch.arange(H, device=per_pixel.device) * Ht // H
    ci = torch.arange(W, device=per_pixel.device) * Wt // W
    tile = (ri[:, None] * Wt + ci[None, :]).reshape(-1)
    out = per_pixel.new_zeros(B, Ht * Wt)
    return out.index_add_(1, tile, per_pixel.reshape(B, -1)).reshape(B, Ht, Wt)


@torch.no_grad()
def frac_quant_backward_torch(x: torch.Tensor, g: torch.Tensor, bit_map: torch.Tensor,
                              x_min: torch.Tensor, x_max: torch.Tensor,
                              mask: Optional[torch.Tensor] = None):
    """The kernel's backward in plain PyTorch (any device): (grad_x in x's
    dtype, grad_bit_map (B, Ht, Wt), grad_mask as `mask`'s shape or None)."""
    from ..core.quantization import per_bit_quantize  # see frac_quantize_torch

    B, H, W, C = x.shape
    Ht, Wt = bit_map.shape[1:]
    xf, gf = x.to(torch.float32), g.to(torch.float32)
    b_floor = torch.floor(bit_map)
    inside = (b_floor >= MIN_BITS) & (b_floor <= MAX_BITS)
    k = torch.where(inside, b_floor, float(MIN_BITS)).to(torch.long) - MIN_BITS
    up = lambda t: iops.upsample_nearest(t, (H, W))[..., None]  # noqa: E731
    f, inside = up(bit_map - b_floor), up(inside)
    qs = torch.stack(list(per_bit_quantize(xf, x_min, x_max, training=True).values()))
    q_lo = qs.gather(0, up(k)[None].expand(1, B, H, W, C))[0]
    q_hi = qs.gather(0, up(torch.clamp(k + 1, max=N_BITS - 1))[None].expand(1, B, H, W, C))[0]
    gm = gf if mask is None else gf * mask.reshape(B, H, W, 1)
    zero = torch.zeros((), device=x.device)
    grad_x = torch.where(inside, gm * (1.0 - f) + gm * f, zero).to(x.dtype)
    x_q = torch.where(inside, (1.0 - f) * q_lo + f * q_hi, zero)
    grad_bits = _tile_sum(torch.where(inside, gm * (q_hi - q_lo), zero).sum(-1), Ht, Wt)
    grad_mask = None if mask is None else (gf * x_q).sum(-1).reshape(mask.shape)
    return grad_x, grad_bits, grad_mask


def _check(x, bit_map, x_min, x_max, mask):
    """Refuse what the kernels do not take; return (B, H, W, C, Ht, Wt)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"frac_quantize: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("frac_quantize: x must be a contiguous (B, H, W, C) NHWC tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    if bit_map.dim() != 3 or bit_map.shape[0] != B:
        raise ValueError(f"frac_quantize: bit_map must be (B, Ht, Wt), got "
                         f"{tuple(bit_map.shape)}")
    named = [("bit_map", bit_map), ("x_min", x_min), ("x_max", x_max)]
    if mask is not None:
        if mask.shape not in ((B, H, W), (B, H, W, 1)):
            raise ValueError(f"frac_quantize: mask must be (B, H, W[, 1]), got "
                             f"{tuple(mask.shape)}")
        named.append(("mask", mask))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"frac_quantize: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"frac_quantize: {name} must be contiguous float32")
    if x_min.shape != x_max.shape or x_min.shape not in ((C,), (N_BITS, C), (N_BITS, 1)):
        raise ValueError(f"frac_quantize: x_min/x_max must be ({C},), ({N_BITS}, {C}) or "
                         f"({N_BITS}, 1), got {tuple(x_min.shape)} / {tuple(x_max.shape)}")
    _, Ht, Wt = bit_map.shape
    if 0 in (B, H, W, C, Ht, Wt):
        raise ValueError(f"frac_quantize: empty map {tuple(x.shape)} or bit map "
                         f"{tuple(bit_map.shape)}")
    if max((H + 1) * Ht, (W + 1) * Wt, B * Ht * Wt) >= _INT32_LIMIT:
        raise ValueError("frac_quantize: the kernels index tiles in 32 bits; (H+1)*Ht, "
                         "(W+1)*Wt and B*Ht*Wt must stay below 2^31")
    return B, H, W, C, Ht, Wt


def _range_strides(x_min: torch.Tensor):
    """(row_stride, col_stride) of the range: row b - 2, channel c at
    row * b + col * c (the table kernel's)."""
    if x_min.dim() == 1:
        return 0, 1
    return (1, 0) if x_min.shape[1] == 1 else (x_min.shape[1], 1)


def _geometry(x: torch.Tensor, Ht: int, Wt: int, *tensors) -> Geometry:
    B, H, W, C = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + tensors)
    return geometry(C, x.element_size(), aligned, -(-H // Ht) * -(-W // Wt))


# the kernels' C entries (csrc/frac_quant.cu)
_FORWARD = Entry("frac_quant", "frac_quant", "mcaq_frac_quant_forward",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
_BACKWARD = Entry("frac_quant", "frac_quant", "mcaq_frac_quant_backward",
                  [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


class _FracQuant(torch.autograd.Function):
    """The kernel pair as one autograd node; it keeps x, the bit map, the
    mask and the 2 x 7 x C table for the backward."""

    @staticmethod
    def forward(ctx, x, bit_map, x_min, x_max, mask):
        B, H, W, C, Ht, Wt = _check(x, bit_map, x_min, x_max, mask)
        out = torch.empty_like(x)
        table = torch.empty((2, N_BITS, C), dtype=torch.float32, device=x.device)
        geo = _geometry(x, Ht, Wt, out)
        _FORWARD.launch(x.device.index, x.data_ptr(), bit_map.data_ptr(), x_min.data_ptr(),
                        x_max.data_ptr(), *_range_strides(x_min),
                        mask.data_ptr() if mask is not None else None, table.data_ptr(),
                        out.data_ptr(), _DTYPE_CODE[x.dtype], B, H, W, C, Ht, Wt, *geo)
        count("frac_quant")
        ctx.save_for_backward(x, bit_map, mask, table)
        ctx.spans = span_stack()   # the backward's launch counts in this thread's span
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, bit_map, mask, table = ctx.saved_tensors
        B, H, W, C = x.shape
        Ht, Wt = bit_map.shape[1:]
        g = g.contiguous()
        grad_x = torch.empty_like(x)
        want_bits, want_mask = ctx.needs_input_grad[1], ctx.needs_input_grad[4]
        grad_bits = torch.empty_like(bit_map) if want_bits else None
        grad_mask = torch.empty_like(mask) if want_mask else None
        geo = _geometry(x, Ht, Wt, g, grad_x)
        _BACKWARD.launch(x.device.index, x.data_ptr(), g.data_ptr(), bit_map.data_ptr(),
                         table.data_ptr(), mask.data_ptr() if mask is not None else None,
                         grad_x.data_ptr(), grad_bits.data_ptr() if want_bits else None,
                         grad_mask.data_ptr() if want_mask else None, _DTYPE_CODE[x.dtype],
                         B, H, W, C, Ht, Wt, *geo)
        count("frac_quant", stack=ctx.spans)
        return grad_x, grad_bits, None, None, grad_mask


def frac_quantize(x: torch.Tensor, bit_map: torch.Tensor, x_min: torch.Tensor,
                  x_max: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training quantize: the kernel pair on CUDA tensors, the plain
    path on CPU tensors (module docstring)."""
    if x.device.type == "cpu":
        return frac_quantize_torch(x, bit_map, x_min, x_max, mask)
    if x.device.type != "cuda":
        raise ValueError(f"frac_quantize: unsupported device {x.device}")
    return _FracQuant.apply(x, bit_map.contiguous(), x_min, x_max, mask)
