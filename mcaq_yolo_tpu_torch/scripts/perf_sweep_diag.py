"""Batch sweep of the MCAQ forward by stage (port of
`mcaq_yolo_tpu/scripts/perf_sweep_diag.py`, same flags and keys).

For each batch size it runs `utils.profiling.component_breakdown`
(backbone / morphology / bit map + quantize / neck + head), normalizes
to µs per image, and reports which stage's per-image cost moves across
the sweep.  The first batch (and bs 128) also gets each stage's roofline
against the H100 SXM data sheet's ceilings (989 TFLOP/s dense bf16,
3,350 GB/s HBM3): achieved TFLOP/s, and the kernel-floor bytes per second
the stage would need at its measured time (`gb_floor`; XLA's op-count
bytes, `gb`, have no counterpart here and are null).

    python -m mcaq_yolo_tpu_torch.scripts.perf_sweep_diag \\
        [--batches 96,128,160,192,224,256] [--out outputs/r3/sweep_diag.json]

`main` runs on CUDA and raises without it; `run(..., device="cpu")` is for
the tests.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..device import resolve_device
from ..models.mcaq_yolo import MCAQYOLO
from ..utils.cuda_timing import BF16_TENSOR_OPS_PER_S, HBM_BYTES_PER_S
from ..utils.profiling import component_breakdown

MATMUL_TFLOPS, STREAM_GBPS = BF16_TENSOR_OPS_PER_S / 1e12, HBM_BYTES_PER_S / 1e9
STAGES = ("backbone", "morphology", "bitmap_quantize", "neck_head")


def run(batches, variant="yolov8n", img=640, iters=20, dtype="bfloat16", downsample=1,
        device=None):
    device = resolve_device(device)
    model = MCAQYOLO(variant=variant, num_classes=80, bit_mapping="mlp",
                     dtype=getattr(torch, dtype), morph_downsample=downsample, device=device)
    results = {}
    stamp = None
    for i, bs in enumerate(batches):
        g = torch.Generator(device="cpu").manual_seed(0)
        images = torch.rand((bs, img, img, 3), generator=g).to(device)
        bd = component_breakdown(model, images, iters=iters, cost=(i == 0 or bs == 128))
        stamp = {k: bd[k] for k in ("device", "nvidia_smi") if k in bd}
        entry = {
            "ms": {k: v for k, v in bd.items() if k.endswith("_ms")},
            "us_per_image": {k: v / bs * 1000 for k, v in bd.items() if k.endswith("_ms")},
            "imgs_per_sec": bs / bd["full_ms"] * 1000,
        }
        if "full_gflops" in bd:
            roof = {}
            for s in STAGES + ("full",):
                ms = bd[f"{s}_ms"]
                if ms <= 0:
                    continue
                tf = bd[f"{s}_gflops"] / ms  # GFLOP / ms = TFLOP/s
                floor_gbps = bd[f"{s}_gb_floor"] / (ms / 1000.0)
                roof[s] = {
                    "gflops": bd[f"{s}_gflops"], "gb": None, "gb_floor": bd[f"{s}_gb_floor"],
                    "achieved_tflops": tf, "achieved_gbps": None,
                    "floor_gbps": floor_gbps,
                    "pct_matmul_ceiling": tf / MATMUL_TFLOPS * 100,
                    "pct_stream_ceiling_floor": floor_gbps / STREAM_GBPS * 100,
                    "bound": ("compute" if tf / MATMUL_TFLOPS > floor_gbps / STREAM_GBPS
                              else "bandwidth"),
                }
            entry["roofline"] = roof
        results[f"bs{bs}"] = entry
        print(f"bs={bs}: {entry}", flush=True)

    stages = list(next(iter(results.values()))["us_per_image"])
    attribution = {}
    for s in stages:
        vals = {b: r["us_per_image"][s] for b, r in results.items()}
        lo, hi = min(vals.values()), max(vals.values())
        attribution[s] = {"us_per_image": vals,
                          "spread_pct": (hi - lo) / max(lo, 1e-9) * 100}
    return {"config": {"variant": variant, "img": img, "dtype": dtype, "iters": iters,
                       "downsample": downsample, **stamp},
            "sweep": results, "attribution": attribution}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="96,128,160,192,224,256")
    p.add_argument("--variant", default="yolov8n")
    p.add_argument("--img", type=int, default=640)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--downsample", type=int, default=1)
    p.add_argument("--out", default="outputs/r3/sweep_diag.json")
    a = p.parse_args(argv)
    device = resolve_device(None)  # CUDA, or raise
    table = run([int(b) for b in a.batches.split(",")], a.variant, a.img, a.iters, a.dtype,
                a.downsample, device=device)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(table, indent=2) + "\n")
    print(json.dumps(table["attribution"], indent=2))


if __name__ == "__main__":
    main()
