"""
Side-by-side device time of the spatial_quant kernel and another source of
it, on one GPU, plus the SASS of both.

Run from the repository root:

    python -m mcaq_yolo_tpu_torch.ops.spatial_quant_ab [--baseline SRC] [--out DIR]

SRC is a CUDA source with the first version's C interface,
`mcaq_spatial_quant(x, bit_map, x_min, x_max, mask, out, dtype, B, H, W, C,
Ht, Wt, stream)`, for example an earlier commit's kernel taken out with
`mkdir -p build/ab && git show <rev>:mcaq_yolo_tpu_torch/csrc/spatial_quant.cu > build/ab/base.cu`.
It is built with the same nvcc flags as the committed kernel (`build.NVCC_FLAGS`).

At yolov8n's three 640-px scales, bs=32, bfloat16, seeded inputs, with and
without the soft mask, each kernel is first held bitwise against
`spatial_quantize_torch`, then timed in turns (baseline, committed,
committed, baseline) by chip_smoke.py's device-only method: 8 back-to-back
launches on distinct inputs, queued behind a device sleep, median of 21.
Each library's SASS goes to DIR (`cuobjdump -sass`), and its instruction
count per kernel is printed.  Beside them, per scale: the device time of
each CUDA kernel of one committed call (`torch.profiler`, 8 calls: the
table kernel and the quantize kernel apart) and `elementwise_ms`, one
`torch.mul` pass over the same x into a preallocated output (the same
bytes read and written, the mask aside), as a floor for a one-pass
elementwise kernel.  One JSON line per reading; exits non-zero on any
mismatch or failed build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..utils.cuda_timing import (COPIES, SLEEP_CYCLES, cuda_ms, host_us_per_call,
                                 quant_bound_ms)
from . import build
from . import spatial_quant as sq

SCALES = (("P3", 80, 64, 10), ("P4", 40, 128, 10), ("P5", 20, 256, 5))
BATCH = 32


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _build_baseline(src: Path, out_dir: Path) -> Path:
    lib = out_dir / "libspatial_quant_baseline.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    _emit({"built": str(src), "ptxas": [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                                        if "registers" in ln or "spill" in ln]})
    return lib


def _baseline_fn(lib_path: Path):
    fn = ctypes.CDLL(str(lib_path)).mcaq_spatial_quant
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, bit_map, lo, hi, mask):
        out = torch.empty_like(x)
        B, H, W, C = x.shape
        _, Ht, Wt = bit_map.shape
        rc = fn(x.data_ptr(), bit_map.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                mask.data_ptr() if mask is not None else None, out.data_ptr(),
                sq._DTYPE_CODE[x.dtype], B, H, W, C, Ht, Wt,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {rc}")
        return out

    return run


def sass_counts(lib: Path, out_dir: Path, tag: str) -> dict:
    """Dump the library's SASS; return the instruction count per kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib}: {r.stderr}")
    (out_dir / f"{tag}.sass").write_text(r.stdout)
    counts, name = {}, None
    for line in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def _kernel_device_us(fn) -> dict:
    """Mean device time per launch of each CUDA kernel that fn(k) runs,
    k = 0 .. COPIES-1 back to back behind a device sleep, by name (µs)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES)
        for k in range(COPIES):
            fn(k)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"(\w+)(?:<[^>]*>)?\(", e.key)
        if e.device_time_total > 0 and name and name.group(1) != "spin_kernel":
            out[name.group(1)] = e.device_time_total / e.count
    return out


def _inputs(device, H, C, t, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((BATCH, H, H, C), generator=g, device=device).to(torch.bfloat16)
    bits = torch.rand((BATCH, t, t), generator=g, device=device) * 7.0 + 1.5
    lo, hi = torch.aminmax(x.reshape(-1, C), dim=0)
    mask = torch.rand((BATCH, H, H), generator=g, device=device)
    return x, bits, lo.float().contiguous(), hi.float().contiguous(), mask


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a CUDA source with the first version's C interface")
    ap.add_argument("--out", type=Path, default=Path("build/spatial_quant_ab"),
                    help="directory for the SASS dumps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spatial_quant_ab: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    _emit({"gpu": smi.stdout.strip(), "torch": torch.__version__, "cuda": torch.version.cuda})

    kernels = {"committed": sq.spatial_quantize}
    libs = {"committed": build.build_all(["spatial_quant"])["spatial_quant"]}
    if args.baseline is not None:
        libs["baseline"] = _build_baseline(args.baseline, args.out)
        kernels["baseline"] = _baseline_fn(libs["baseline"])
    for tag, lib in libs.items():
        _emit({"sass": tag, "library": lib.name, "instructions": sass_counts(lib, args.out, tag)})
    _emit({"ptxas_committed": [ln.strip() for ln in build.build_log("spatial_quant").splitlines()
                               if "registers" in ln or "spill" in ln]})

    order = ["baseline", "committed", "committed", "baseline"] if "baseline" in kernels \
        else ["committed", "committed"]
    ok = True
    for seed, (name, H, C, t) in enumerate(SCALES):
        x, bits, lo, hi, mask = _inputs(device, H, C, t, seed)
        xs = [x.clone() for _ in range(COPIES)]
        masks = [mask.clone() for _ in range(COPIES)]
        for with_mask in (True, False):
            m_of = (lambda k: masks[k]) if with_mask else (lambda k: None)
            ref = sq.spatial_quantize_torch(x, bits, lo, hi, m_of(0))
            row = {"scale": name, "shape": list(x.shape), "dtype": "bfloat16",
                   "mask": with_mask, "bound_ms": quant_bound_ms(x, bits, m_of(0))}
            for tag, fn in kernels.items():
                out = fn(xs[0], bits, lo, hi, m_of(0))
                torch.cuda.synchronize()
                mism = int((out.view(torch.int16) != ref.view(torch.int16)).sum())
                row[f"{tag}_mismatches"] = mism
                ok &= mism == 0
            for tag in order:
                fn = kernels[tag]
                row.setdefault(f"{tag}_ms", []).append(cuda_ms(
                    lambda k, fn=fn: fn(xs[k], bits, lo, hi, m_of(k)),
                    inner=COPIES, device_only=True))
            for tag, fn in kernels.items():
                row[f"{tag}_host_us_per_call"] = host_us_per_call(
                    lambda k, fn=fn: fn(xs[k], bits, lo, hi, m_of(k)))
            row["committed_kernels_us"] = _kernel_device_us(
                lambda k: sq.spatial_quantize(xs[k], bits, lo, hi, m_of(k)))
            _emit(row)
        ob = torch.empty_like(x)
        _emit({"scale": name, "elementwise_ms": cuda_ms(
            lambda k: torch.mul(xs[k], 2.0, out=ob), inner=COPIES, device_only=True)})
        del xs, masks
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
