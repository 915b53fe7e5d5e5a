"""Per-stage roofline of the MCAQ-YOLO serving program on the GPU (port of
`mcaq_yolo_tpu/scripts/roofline.py`, same flags and keys).

For each stage (backbone / morphology / bit map + quantize / neck + head /
decode + NMS) it reports the measured time (`utils.profiling.
component_breakdown`, and the deployed program for decode + NMS), the
FLOPs and the kernel-floor bytes counted from the dispatched ops
(`utils.profiling.KernelFloorMode`: each convolution and matmul reads its
operands and writes its result once, every other op fused away), and the
stage's bound

    t_bound = max(gflops / peak_tflops, gb_floor / peak_gbps)

which, the floor being optimistic, the stage can approach but not beat.
`gb_oplevel` (XLA's op-count bytes in the JAX package) has no counterpart
here and is null.  The ceilings default to the H100 SXM data sheet: 989
TFLOP/s dense bf16, 3,350 GB/s HBM3, at a 700 W power limit; the output
carries the card's name and power limit.

The decode + NMS stage is the deployed program (`inference.deployed_program`,
which `Predictor` serves; conf 0.25, IoU 0.45, max_det 300, the pool
`auto_pre_topk(300)`, deploy temperature 1) minus the forward, the two
timed in turns (median of the per-round differences).

    python -m mcaq_yolo_tpu_torch.scripts.roofline --batch 256 [--variant yolov8n]

`main` runs on CUDA and raises without it; `run(..., device="cpu")` is for
the tests.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..device import resolve_device
from ..inference import deployed_program
from ..models.mcaq_yolo import MCAQYOLO
from ..utils.cuda_timing import BF16_TENSOR_OPS_PER_S, HBM_BYTES_PER_S
from ..utils.profiling import (breakdown_programs, component_breakdown, interleaved_ms,
                               paired_median_ms, program_cost)

PEAK_TFLOPS = BF16_TENSOR_OPS_PER_S / 1e12  # 989
PEAK_GBPS = HBM_BYTES_PER_S / 1e9           # 3,350
STAGES = ("backbone", "morphology", "bitmap_quantize", "neck_head", "decode_nms")


def run(variant="yolov8n", batch=256, img=640, iters=20, peak_tflops=PEAK_TFLOPS,
        peak_gbps=PEAK_GBPS, device=None):
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = MCAQYOLO(variant=variant, num_classes=80, bit_mapping="mlp", dtype=dtype,
                     device=device)
    g = torch.Generator(device="cpu").manual_seed(1)
    images = torch.randint(0, 256, (batch, img, img, 3), generator=g,
                           dtype=torch.uint8).to(device)

    bd = component_breakdown(model, images, iters=iters, cost=True)

    def e2e(x):
        return deployed_program(model, x, 80, max_det=300)

    with torch.inference_mode():
        # the full forward again, in turns with the program that adds decode + NMS
        t = interleaved_ms({"full": breakdown_programs(model)["full"], "e2e": e2e}, images,
                           iters, device=device)
        c = program_cost(e2e, images, state=list(model.state_dict().values()))
    bd["decode_nms_ms"] = paired_median_ms(t, "e2e", "full")
    bd["e2e_ms"] = statistics.median(t["e2e"])
    bd["decode_nms_gflops"] = c["flops"] / 1e9 - bd["full_gflops"]
    bd["decode_nms_gb_floor"] = c["floor_bytes"] / 1e9 - bd["full_gb_floor"]

    rows = []
    for s in STAGES:
        ms = bd[f"{s}_ms"]
        gf = bd.get(f"{s}_gflops", 0.0)
        gb_floor = max(bd.get(f"{s}_gb_floor", 0.0), 0.0)
        t_flops = gf / peak_tflops  # GFLOP / (TFLOP/s) = ms
        t_bytes = gb_floor / peak_gbps * 1e3
        bound = max(t_flops, t_bytes)
        rows.append({
            "stage": s, "ms": ms, "gflops": gf, "gb_floor": gb_floor, "gb_oplevel": None,
            "bound_ms": bound, "bound_by": "flops" if t_flops >= t_bytes else "bytes",
            "pct_of_bound": 100 * bound / ms if ms > 1e-6 else None,
            "achieved_tflops": gf / ms if ms > 1e-6 else None,
            "floor_gbps_if_at_bound": gb_floor / ms * 1e3 if ms > 1e-6 else None,
        })
    total_bound = sum(r["bound_ms"] for r in rows)
    return {
        "byte_model": "kernel_floor (each convolution and matmul reads its operands and "
                      "writes its result once; all else fused; see utils.profiling."
                      "KernelFloorMode); gb_oplevel has no counterpart (null)",
        "config": {"variant": variant, "batch": batch, "img": img, "dtype": str(dtype),
                   "images": "uint8", "peak_tflops": peak_tflops, "peak_gbps": peak_gbps},
        "device": bd["device"], "nvidia_smi": bd.get("nvidia_smi"),
        "stages": rows,
        "full_ms": bd["full_ms"],
        "e2e_ms": bd["e2e_ms"],
        "e2e_img_per_s": batch / bd["e2e_ms"] * 1e3,
        "forward_img_per_s": batch / bd["full_ms"] * 1e3,
        "sum_stage_bound_ms": total_bound,
        "e2e_pct_of_composite_bound": 100 * total_bound / bd["e2e_ms"],
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--variant", default="yolov8n")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--img", type=int, default=640)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--peak-tflops", type=float, default=PEAK_TFLOPS)
    p.add_argument("--peak-gbps", type=float, default=PEAK_GBPS)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = resolve_device(None)  # CUDA, or raise
    res = run(args.variant, args.batch, args.img, args.iters, args.peak_tflops,
              args.peak_gbps, device=device)
    s = json.dumps(res, indent=2)
    print(s)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s + "\n")


if __name__ == "__main__":
    main()
