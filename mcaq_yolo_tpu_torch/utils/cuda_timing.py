"""
Device timing with CUDA events, and the kernels' bounds.

`chip_smoke.py`'s kernel tables and the port's diagnostic scripts read the
card through these.  Every function here needs a CUDA device.
"""

from __future__ import annotations

import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM FP32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
# per element: divide, add, rint, 2 clamps, subtract, multiply, mask multiply
QUANT_OPS_PER_ELEMENT = 8
# per element of eval BatchNorm + SiLU: subtract, multiply, multiply-add (2),
# exp, add, divide
BN_SILU_OPS_PER_ELEMENT = 7
# per element of the training quantize (csrc/frac_quant.cu), two fake
# quantizations of 9 (divide, add, rint, 2 clamps, subtract, multiply and
# the straight-through subtract and add) and, forward, the blend (3) and
# the mask (1); backward, the mask, grad x (3), the blend (3) and the two
# sums' products and adds (5)
FRAC_QUANT_OPS_PER_ELEMENT = {"forward": 22, "backward": 30}
# distinct copies of a kernel's inputs cycled in one timed round: at the
# yolov8n scales their working set exceeds the 50 MB L2
COPIES = 8
L2_BYTES = 50 * 2**20  # H100 SXM L2 cache
# ~10 ms at the H100's clocks: longer than the host needs to queue one
# timed round of launches
SLEEP_CYCLES = 20_000_000


def cuda_ms(fn, reps: int = 21, inner: int = 1, warmup: int = 3,
            device_only: bool = False) -> float:
    """Median over `reps` of the time per call of fn(k), k = 0 .. inner-1
    called back to back between two CUDA events.

    device_only: the calls are queued behind a device-side sleep issued
    before the first event, so the card runs them without waiting on the
    host between launches and the events measure device time alone.
    Otherwise the host's enqueue time counts, as it does for a caller."""
    for _ in range(warmup):
        for k in range(inner):
            fn(k)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for k in range(inner):
            fn(k)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_us_per_call(fn, calls: int = 64) -> float:
    """Host time per call of fn(k) (enqueue only, no synchronise), in µs."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)  # keep the queue from filling meanwhile
    t0 = time.perf_counter()
    for k in range(calls):
        fn(k % COPIES)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def quant_bytes(x, bit_map, mask) -> int:
    """Bytes the fused quantizer must move: x read once, output written
    once, bit map, per-channel range and mask read once."""
    C = x.shape[-1]
    n = 2 * x.numel() * x.element_size() + bit_map.numel() * 4 + 2 * C * 4
    return n + (mask.numel() * 4 if mask is not None else 0)


def bn_silu_bytes(numel: int, element_size: int, channels: int) -> int:
    """Bytes one eval BatchNorm + SiLU pass over a map must move: the map
    read once and written once, the four per-channel float32 vectors read
    once."""
    return 2 * numel * element_size + 4 * channels * 4


def frac_quant_bytes(x, bit_map, direction: str) -> int:
    """Bytes one pass of the training quantize over x (B, H, W, C) must move,
    with the soft mask: forward x read and the output written, the mask and
    the bit map read; backward x and its gradient read, grad x written, the
    mask read and its gradient written, the bit map read and its gradient
    written.  The 2 x 7 x C table is noise."""
    pixels = x.numel() // x.shape[-1]
    if direction == "forward":
        return 2 * x.numel() * x.element_size() + pixels * 4 + bit_map.numel() * 4
    return 3 * x.numel() * x.element_size() + 2 * pixels * 4 + 2 * bit_map.numel() * 4


def bound_ms(n_bytes: int, n_ops: int):
    """(the least time in ms the card could take to move `n_bytes` and do
    `n_ops` f32 operations, "bytes" or "operations": whichever bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def quant_bound_ms(x, bit_map, mask) -> float:
    """The least time the card could take for one quantize: the larger of
    its bytes over the HBM rate and its f32 operations over the f32 rate."""
    return bound_ms(quant_bytes(x, bit_map, mask), x.numel() * QUANT_OPS_PER_ELEMENT)[0]
