"""
Eval BatchNorm + SiLU after a convolution in one pass: the CUDA kernel's
wrapper and the rule by which `models/layers.py:ConvBnSiLU` takes it.

The kernel is `csrc/bn_silu.cu`; see its source note for the design and
what bounds it.  It replaces no TPU kernel: XLA fuses this epilogue into the
convolution in the JAX package.

  bn_silu_(x, bn)
      In place, x = silu(bn(x)) with bn's running statistics and affine
      parameters, through the registered op `torch.ops.mcaq.bn_silu`, so
      eager code and a `torch.export` program run the same node: on CUDA
      tensors the op launches the kernel (or raises: there is no fallback),
      on CPU tensors it runs the plain version.  Returns x.
  bn_silu_torch(x, weight, bias, running_mean, running_var, eps)
      The plain version, `F.silu(F.batch_norm(x, ...))`: BatchNorm's output
      rounded to x's dtype, then the SiLU, as ConvBnSiLU computes it off the
      kernel.  On the card the kernel is held to it bitwise wherever ATen
      normalizes with its channels-last kernel (see the kernel's note).
  takes(x, bn)
      Whether ConvBnSiLU's eval epilogue on the convolution output x goes to
      the kernel: x on CUDA and nothing to differentiate (`needs_grad`).

x is (N, C, H, W), float32 or bfloat16, with C at most MAX_CHANNELS, in
contiguous channels-last memory (cuDNN's convolutions write it) or
contiguous NCHW (PyTorch's own convolution, with cuDNN off); the four
vectors are (C,) float32.  On a channels-last map whose C is a multiple of
the 16-byte group (4 float32 or 8 bfloat16 channels) the kernel moves whole
groups and x must be 16-byte aligned; any other map runs element by
element.  It raises on anything else.  Every launch adds one to the
program's counter `bn_silu` (`utils/profiling.py:count`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.profiling import count, counters
from .build import Entry

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # channels in one 16-byte group
# the kernel's block (csrc/bn_silu.cu): THREADS threads, UNROLL 16-byte groups
# each, one contiguous tile of THREADS * UNROLL groups a block
THREADS, UNROLL = 128, 4
MAX_CHANNELS = 3072  # kMaxChannels: four float32 parameters a channel in 48 KB of shared memory


def bn_silu_torch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  running_mean: torch.Tensor, running_var: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device), a new tensor."""
    return F.silu(F.batch_norm(x, running_mean, running_var, weight, bias, False, 0.0, eps))


def takes(x: torch.Tensor, bn: torch.nn.BatchNorm2d) -> bool:
    """True when the kernel takes the convolution output x for bn: x on
    CUDA and not `needs_grad(x, bn)` (the kernel has no backward).  On the
    CPU, and in eval with gradients, ConvBnSiLU keeps `F.batch_norm` +
    `F.silu`."""
    return x.is_cuda and not needs_grad(x, bn)


def needs_grad(x: torch.Tensor, bn: torch.nn.BatchNorm2d) -> bool:
    """Autograd would record the epilogue: grad is on and x or bn's affine
    parameters require it."""
    return torch.is_grad_enabled() and (x.requires_grad or bn.weight.requires_grad
                                        or bn.bias.requires_grad)


def launches() -> int:
    """The kernel's launches so far in this process (the counter `bn_silu`)."""
    return counters().get("bn_silu", 0)


# the kernel's C entry (csrc/bn_silu.cu)
_ENTRY = Entry("bn_silu", "bn_silu", "mcaq_bn_silu",
               [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])


def _plane(x) -> int:
    """Elements of one channel's contiguous run: 1 for a channels-last map,
    H * W for an NCHW one, 0 for any other layout."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    return max(x.shape[2] * x.shape[3], 1) if x.is_contiguous() else 0


def _check(x, weight, bias, running_mean, running_var) -> int:
    """Refuse what the kernel does not take; return C."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"bn_silu: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not _plane(x):
        raise ValueError("bn_silu: x must be an (N, C, H, W) tensor in contiguous "
                         f"channels-last or NCHW memory, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    C = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.device != x.device:
            raise ValueError(f"bn_silu: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != (C,):
            raise ValueError(f"bn_silu: {name} must be a contiguous ({C},) float32 tensor")
    if not 0 < C <= MAX_CHANNELS:
        raise ValueError(f"bn_silu: C={C} channels; the kernel takes 1 to {MAX_CHANNELS}")
    vec = _VEC[x.dtype]
    if _plane(x) == 1 and C % vec == 0 and x.data_ptr() % 16:
        raise ValueError(f"bn_silu: the kernel moves C={C} channels in 16-byte groups of {vec}; "
                         "x must be 16-byte aligned")
    return C


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            running_mean: torch.Tensor, running_var: torch.Tensor, eps: float) -> None:
    """The kernel on CUDA tensors: checks, launches in place, counts."""
    C = _check(x, weight, bias, running_mean, running_var)
    if x.numel() == 0:
        return
    _ENTRY.launch(x.device.index, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  running_mean.data_ptr(), running_var.data_ptr(), eps, _DTYPE_CODE[x.dtype],
                  x.numel() // C, C, _plane(x))
    count("bn_silu")


# The kernel as a registered op that writes over x: the plain version on the
# CPU, the kernel on CUDA, nothing while a program is traced (torch.export),
# so an exported program carries the op as a node.
@torch.library.custom_op("mcaq::bn_silu", mutates_args=("x",), device_types="cpu")
def _bn_silu_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                running_mean: torch.Tensor, running_var: torch.Tensor, eps: float) -> None:
    x.copy_(bn_silu_torch(x, weight, bias, running_mean, running_var, eps))


_bn_silu_op.register_kernel("cuda")(_launch)


@_bn_silu_op.register_fake
def _(x, weight, bias, running_mean, running_var, eps):
    return None


def bn_silu_(x: torch.Tensor, bn: torch.nn.BatchNorm2d) -> torch.Tensor:
    """x = silu(bn(x)) in place with bn's running statistics (eval), through
    the registered op `mcaq::bn_silu`; returns x."""
    torch.ops.mcaq.bn_silu(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    return x

