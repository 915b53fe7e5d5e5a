"""
Fused spatial quantize -> dequantize (x soft mask): the CUDA kernel's
wrapper and its plain PyTorch version.

Port of the TPU kernel `mcaq_yolo_tpu/ops/pallas_quant.py:
spatial_quantize_pallas` (its three pallas_call sites compute one
function).  The kernel is `csrc/spatial_quant.cu`; see its source note for
the design and what bounds it.

  spatial_quantize(x, bit_map, x_min, x_max, mask=None)
      CUDA tensors -> launches the kernel (or raises: there is no fallback);
      CPU tensors  -> the plain version.
  spatial_quantize_torch(...)
      The same function in plain PyTorch, the arithmetic of the reference's
      `_compose_integer` (`core/quantization.py:421-460`) in the same
      literal order, so the kernel is held to it bitwise.

x is (B, H, W, C) NHWC-contiguous, float32 or bfloat16; bit_map (B, Ht, Wt)
float32; x_min / x_max (C,) float32; mask (B, H, W) or (B, H, W, 1)
float32.  The kernel moves 16 bytes of channels per thread, so on CUDA C is
a multiple of 4 (float32) or 8 (bfloat16) and x is 16-byte aligned, as every
YOLOv8 variant's C3/C4/C5 map is; it raises otherwise.  Math in float32,
output in x's dtype.  Tile of pixel (h, w) is
(floor(h * Ht / H), floor(w * Wt / W)) — the reference model path's rule;
the Pallas kernel clamps remainder pixels into the last tile instead, and
the two agree on exact tile multiples.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import image_ops as iops

MIN_BITS, MAX_BITS = 2, 8
N_BITS = MAX_BITS - MIN_BITS + 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 48 * 1024  # static shared-memory budget of one block


def precompute_qparams(x_min: torch.Tensor, x_max: torch.Tensor):
    """Per-(bit, channel) tables (scale, inv_scale, zp), each (7, C) float32
    — the table the kernel builds in shared memory (reference
    `pallas_quant.py:92-101`)."""
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
    x_range = torch.clamp(x_max - x_min, min=1e-8)
    scale = x_range / d
    zp = torch.clamp(qmin - x_min / scale, qmin, qmax)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale + zp), qmin, qmax)
    out = (q - zp) * scale
    if mask is not None:
        out = out * mask.reshape(B, H, W, 1)
    return out.to(x.dtype)


def _check(x, bit_map, x_min, x_max, mask):
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
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"spatial_quantize: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"spatial_quantize: {name} must be contiguous float32")
    if x_min.shape != (C,) or x_max.shape != (C,):
        raise ValueError(f"spatial_quantize: x_min/x_max must be ({C},)")
    if 2 * N_BITS * C * 4 > _MAX_SMEM:
        raise ValueError(f"spatial_quantize: C={C} exceeds the kernel's table budget")
    vec = 16 // x.element_size()
    if C % vec or x.data_ptr() % 16:
        raise ValueError(f"spatial_quantize: the kernel moves 16 bytes ({vec} channels) "
                         f"per thread; C={C} must be a multiple of {vec} and x 16-byte "
                         "aligned")


def _kernel():
    """The kernel's C entry point, built, loaded and typed on first use."""
    global _kernel_fn
    if _kernel_fn is None:
        from .build import load_library

        fn = load_library("spatial_quant").mcaq_spatial_quant
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


_kernel_fn = None


def spatial_quantize(x: torch.Tensor, bit_map: torch.Tensor, x_min: torch.Tensor,
                     x_max: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused kernel on CUDA tensors; the plain version on CPU tensors.

    `spatial_quantize.launches` counts kernel launches (and nothing else)."""
    if x.device.type == "cpu":
        return spatial_quantize_torch(x, bit_map, x_min, x_max, mask)
    if x.device.type != "cuda":
        raise ValueError(f"spatial_quantize: unsupported device {x.device}")
    _check(x, bit_map, x_min, x_max, mask)
    fn = _kernel()
    B, H, W, C = x.shape
    _, Ht, Wt = bit_map.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), bit_map.data_ptr(), x_min.data_ptr(), x_max.data_ptr(),
                mask.data_ptr() if mask is not None else None, out.data_ptr(),
                _DTYPE_CODE[x.dtype], B, H, W, C, Ht, Wt, stream)
    if rc != 0:
        raise RuntimeError(f"spatial_quant kernel launch failed: CUDA error {rc}")
    spatial_quantize.launches += 1
    return out


spatial_quantize.launches = 0
