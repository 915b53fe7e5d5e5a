"""
Float32 convolution at float32 accuracy on the tensor cores: the Triton
kernel's wrapper, its plain PyTorch version, its tile rule and the rule by
which `models/layers.py:ConvBnSiLU` takes it.

The kernel is `csrc/conv_f32.py`; see its source note for the design and
what bounds it.  It replaces no TPU kernel: the JAX teacher's convolutions
are XLA's.

  conv_f32(x, weight, stride, padding), conv2d(x, conv)
      The convolution (no bias), always through the registered op
      `torch.ops.mcaq.conv_f32`: on CUDA tensors the kernel (or it raises:
      there is no fallback), on CPU tensors the plain version.  Returns a
      new float32 map in channels-last memory.  A traced program
      (torch.export, torch.compile) records the op as a node, so an
      exported float32 program launches the kernel where the eager one does.
  conv_f32_torch(x, weight, stride, padding)
      The plain version: the kernel's three TF32 products, each operand
      split on its bits (`split_tf32`), as three float32 `F.conv2d`s, the
      two small ones summed first.  A yardstick of the arithmetic, not of
      speed.
  takes(x, conv)
      Whether ConvBnSiLU's convolution of x goes to the kernel: x float32
      on CUDA, conv's weight float32, one group, CUDA autocast off and
      nothing to differentiate.  Tested for every ConvBnSiLU call, so the
      cheapest test (the dtype, which a bf16 network fails) comes first.
  tiles(cin, cout, kh, kw)
      The kernel's tile configuration: a fixed rule on the shape, no
      autotuning at run time.

x is (N, Cin, H, W) float32 with channel stride 1 (channels-last memory, or
a channel slice of a channels-last map, as C2f's split hands its
bottlenecks); any other layout is copied to channels-last first.  The
weight is (Cout, Cin, KH, KW) float32, channels-last (a model moved with
`memory_format=torch.channels_last` has it so), or is copied so.  Dilation
1, zero padding.  Every launch adds one to the program's counter `conv_f32`
(`utils/profiling.py:count`).  The kernel is compiled by Triton at its
first launch for each tile configuration, into `build/triton` beside the
nvcc builds (`TRITON_CACHE_DIR`, unless set).
"""

from __future__ import annotations

import importlib.util
import os
from typing import List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..utils.profiling import count, counters
from .build import BUILD_DIR, CSRC

_INT32_LIMIT = 2 ** 31 - 1
_kernel = None


class Tiles(NamedTuple):
    """One launch configuration of the kernel."""
    bm: int      # output pixels a block
    bn: int      # output channels a block
    bk: int      # K a step: channels of one tap, or (flat) of the taps in turn
    flat: bool   # K flattened over (tap, channel): for a Cin under one step
    warps: int
    stages: int  # K steps in flight (Triton's software pipeline)


def tiles(cin: int, cout: int, kh: int, kw: int) -> Tiles:
    """The tile configuration for a convolution of these widths, a rule
    fixed by a sweep at the KD teacher's shapes on an H100: 128 output
    pixels a block; BN 128 where it wastes no more of N than 64 does (Cout
    96, 384), else 64 (48, 64, 192, 288, 576); K steps of 32 channels where
    Cin fills them, else 16 (Cin 48), the stem's Cin 3 flattened over the
    taps; 8 warps and 3 steps in flight at BN 128, 4 and 4 at BN 64 (the
    stem 3)."""
    bn = 128 if -(-cout // 128) * 128 == -(-cout // 64) * 64 else 64
    flat = cin < 16
    bk = 32 if cin % 32 == 0 else 16
    if bn == 128:
        return Tiles(128, 128, bk, flat, 8, 3)
    return Tiles(128, 64, bk, flat, 4, 3 if flat else 4)


def split_tf32(t: torch.Tensor):
    """(hi, lo): hi = t rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero, on the bits), lo = t - hi rounded so: the kernel's
    operands."""
    def tf32(u):
        return ((u.view(torch.int32) + 0x1000) & -8192).view(torch.float32)

    hi = tf32(t)
    return hi, tf32(t - hi)


def conv_f32_torch(x: torch.Tensor, weight: torch.Tensor, stride: Sequence[int],
                   padding: Sequence[int]) -> torch.Tensor:
    """The plain version (any device): lo(x) hi(w) + hi(x) lo(w), then +
    hi(x) hi(w), each a float32 `F.conv2d` of exact TF32 operands, so every
    product is exact and only the sums' order differs from the kernel's
    (cuDNN's TF32 off, so its sums round to nearest)."""
    (xh, xl), (wh, wl) = split_tf32(x), split_tf32(weight)

    def conv(a, b):
        return F.conv2d(a, b, None, tuple(stride), tuple(padding))

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = (conv(xl, wh) + conv(xh, wl)) + conv(xh, wh)
    return y.contiguous(memory_format=torch.channels_last)


def takes(x: torch.Tensor, conv: torch.nn.Conv2d) -> bool:
    """True when the kernel takes conv's convolution of x (module
    docstring); False sends it to `conv(x)` as before."""
    return (x.dtype is torch.float32 and x.is_cuda and conv.weight.dtype is torch.float32
            and conv.groups == 1 and not torch.is_autocast_enabled("cuda")
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or conv.weight.requires_grad)))


def launches() -> int:
    """The kernel's launches so far in this process (the counter `conv_f32`)."""
    return counters().get("conv_f32", 0)


def kernel():
    """The Triton kernel (`csrc/conv_f32.py`), imported at its first use:
    triton is imported there, never when this module is."""
    global _kernel
    if _kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
        spec = importlib.util.spec_from_file_location("mcaq_yolo_tpu_torch.csrc.conv_f32",
                                                      CSRC / "conv_f32.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _kernel = module.conv_f32_kernel
    return _kernel


def out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def _check(x, weight, stride, padding):
    """Refuse what the kernel does not take; return (x, weight) with channel
    stride 1 (copied to channels-last where they are not)."""
    for name, t in (("x", x), ("weight", weight)):
        if t.dtype != torch.float32:
            raise TypeError(f"conv_f32: {name} must be float32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"conv_f32: {name} must be 4-d, got shape {tuple(t.shape)}")
    if weight.device != x.device:
        raise ValueError(f"conv_f32: weight on {weight.device}, x on {x.device}")
    if weight.shape[1] != x.shape[1]:
        raise ValueError(f"conv_f32: weight {tuple(weight.shape)} for {x.shape[1]} "
                         "input channels (groups must be 1)")
    if len(stride) != 2 or len(padding) != 2 or min(stride) < 1 or min(padding) < 0:
        raise ValueError(f"conv_f32: stride {stride}, padding {padding}")
    if x.stride(1) != 1:
        x = x.contiguous(memory_format=torch.channels_last)
    if not weight.is_contiguous(memory_format=torch.channels_last):
        weight = weight.contiguous(memory_format=torch.channels_last)
    if max(x.stride(0), weight.numel()) > _INT32_LIMIT:
        raise ValueError("conv_f32: the kernel indexes one image and the weight in 32 bits")
    return x, weight


def _launch(x: torch.Tensor, weight: torch.Tensor, stride: Sequence[int],
            padding: Sequence[int]) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, allocates the output, launches,
    counts."""
    x, weight = _check(x, weight, stride, padding)
    N, Cin, H, W = x.shape
    Cout, _, KH, KW = weight.shape
    Ho, Wo = (out_size(H, KH, stride[0], padding[0]), out_size(W, KW, stride[1], padding[1]))
    y = torch.empty((N, Cout, max(Ho, 0), max(Wo, 0)), dtype=torch.float32, device=x.device,
                    memory_format=torch.channels_last)
    M = N * Ho * Wo
    if M <= 0 or Cout == 0:
        return y
    if M > _INT32_LIMIT:
        raise ValueError(f"conv_f32: the kernel indexes output pixels in 32 bits, got {M}")
    t = tiles(Cin, Cout, KH, KW)
    grid = (-(-M // t.bm) * -(-Cout // t.bn),)
    # the weight's halves, split at every call (a few elementwise passes
    # over the weight), so a weight changed in any way is read anew
    w_hi, w_lo = (t.contiguous(memory_format=torch.channels_last)
                  for t in split_tf32(weight))
    args = (x, w_hi, w_lo, y, M, H, W, Ho, Wo, Cin, Cout, x.stride(0), x.stride(2),
            x.stride(3), w_hi.stride(0), stride[0], stride[1], padding[0], padding[1])
    meta = dict(KH=KH, KW=KW, BM=t.bm, BN=t.bn, BK=t.bk, FLAT_K=t.flat, num_warps=t.warps,
                num_stages=t.stages)
    fn = kernel()[grid]
    if x.device.index == torch.cuda.current_device():  # Triton launches on the current one
        fn(*args, **meta)
    else:
        with torch.cuda.device(x.device):
            fn(*args, **meta)
    count("conv_f32")
    return y


# The kernel as a registered op: the plain version on the CPU, the kernel
# on CUDA, nothing while a program is traced, so a `torch.export` program
# carries the op as a node and launches the kernel where eager code does.
@torch.library.custom_op("mcaq::conv_f32", mutates_args=(), device_types="cpu")
def _conv_f32_op(x: torch.Tensor, weight: torch.Tensor, stride: List[int],
                 padding: List[int]) -> torch.Tensor:
    return conv_f32_torch(x, weight, stride, padding)


@_conv_f32_op.register_kernel("cuda")
def _(x, weight, stride, padding):
    return _launch(x, weight, stride, padding)


@_conv_f32_op.register_fake
def _(x, weight, stride, padding):
    N, _, H, W = x.shape
    Cout, _, KH, KW = weight.shape
    return torch.empty((N, Cout, out_size(H, KH, stride[0], padding[0]),
                        out_size(W, KW, stride[1], padding[1])), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


def conv_f32(x: torch.Tensor, weight: torch.Tensor, stride: Sequence[int],
             padding: Sequence[int]) -> torch.Tensor:
    """The convolution of x by weight through the op `mcaq::conv_f32`: the
    kernel on CUDA tensors (or it raises: there is no fallback), the plain
    version on CPU tensors."""
    return torch.ops.mcaq.conv_f32(x, weight, list(stride), list(padding))


def conv2d(x: torch.Tensor, conv: torch.nn.Conv2d) -> torch.Tensor:
    """conv's convolution of x by `conv_f32` (conv: no bias, one group,
    dilation 1)."""
    return conv_f32(x, conv.weight, conv.stride, conv.padding)
