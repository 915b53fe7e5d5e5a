"""Train-step stage breakdown and roofline (port of
`mcaq_yolo_tpu/scripts/train_breakdown.py`, same flags and keys): the MCAQ
train step of `train.make_train_step` (bf16 autocast on CUDA, the MCAQ
math in float32) split by timing sub-programs and taking deltas:

  backbone_fwd             train-mode backbone
  morphology               + complexity maps                       (delta)
  quantize_neck_head_fwd   + bit maps, fractional quantize, neck, head (delta)
  tal_loss                 + the Eq.20 loss with the TAL assigner   (delta)
  backward                 + backward                               (delta)
  optimizer_projection     the whole step minus that: clip, AdamW, Eq.18
  teacher_fwd_kd_increment with --kd, the float32 teacher's forward alone

The six programs run in turns (`utils.profiling.interleaved_ms`); each
delta is the median of its per-round differences.

The forwards record autograd as the step's forward does.  Each sub-program
mutates BatchNorm and quantizer statistics as the step would; the times do
not depend on their values.  The whole step's FLOPs and kernel-floor bytes
come from `utils.profiling.KernelFloorMode` over the step (a convolution's
backward counts as two convolutions); its bound is max(FLOPs over 989
TFLOP/s, floor bytes over 3,350 GB/s), the H100 SXM data sheet's bf16 and
HBM3 rates.  The step launches no spatial_quant kernel: the training
forward composes its quantizer in PyTorch ops, as the reference's does.

    python -m mcaq_yolo_tpu_torch.scripts.train_breakdown [--variant yolov8m]
        [--batch 32] [--img 640] [--iters 10] [--kd] [--out FILE]

`main` runs on CUDA and raises without it; `run(..., device="cpu")` is for
the tests (float32, no autocast).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics

import numpy as np
import torch

from ..device import resolve_device
from ..models.losses import MCAQYOLOLoss
from ..models.mcaq_yolo import MCAQYOLO
from ..models.yolo import YOLOv8, images_to_nchw
from ..train import Optimizer, make_train_step
from ..utils.cuda_timing import BF16_TENSOR_OPS_PER_S, HBM_BYTES_PER_S
from ..utils.profiling import (device_stamp, interleaved_ms, paired_median_ms, program_cost,
                               timed)

LOSS_WEIGHTS = {"detection": 1.0, "bit_budget": 0.1, "smoothness": 0.1,
                "distillation": 0.5, "regularization": 1e-4}


def run(variant="yolov8m", batch=32, img=640, iters=10,
        peak_tflops=BF16_TENSOR_OPS_PER_S / 1e12, peak_gbps=HBM_BYTES_PER_S / 1e9,
        kd=False, device=None):
    device = resolve_device(device)
    amp_dtype = torch.bfloat16 if device.type == "cuda" else None
    model = MCAQYOLO(variant=variant, num_classes=80, bit_mapping="mlp", device=device)
    model.train()
    loss_obj = MCAQYOLOLoss(num_classes=80)
    rng = np.random.default_rng(0)
    M = 16
    g = torch.Generator(device="cpu").manual_seed(1)
    batch_d = {
        "image": torch.rand((batch, img, img, 3), generator=g).to(device),
        "gt_boxes": torch.from_numpy(np.sort(rng.uniform(0, img, (batch, M, 2, 2)), axis=2)
                                     .reshape(batch, M, 4).astype(np.float32)).to(device),
        "gt_classes": torch.from_numpy(rng.integers(0, 80, (batch, M)).astype(np.int32)
                                       ).to(device),
        "gt_mask": torch.from_numpy(rng.random((batch, M)) < 0.5).to(device),
    }
    images = batch_d["image"]
    optimizer = Optimizer(model, lambda step: 1e-3, weight_decay=0.05)
    step = make_train_step(model, loss_obj, amp_dtype=amp_dtype)

    def amp(enabled=True):
        if amp_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=amp_dtype, enabled=enabled)

    # ---- sub-programs -------------------------------------------------
    def backbone_train(x):
        with amp():
            return model.backbone(images_to_nchw(x, model.dtype), True)

    def morph_train(x):
        feats = backbone_train(x)
        with amp(enabled=False):  # the MCAQ math runs in float32
            return [model.complexity_analyzer(
                f.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1))
                for f in feats]

    def fwd_train(x):
        with amp():
            return model(x, temperature=1.0, quantize=True, training=True)

    def loss_value(b):
        raw_maps, aux = fwd_train(b["image"])
        total, _ = loss_obj(raw_maps, b, aux, teacher_maps=None, mapper=model.bit_mapper,
                            loss_weights=LOSS_WEIGHTS, target_bits=4.0)
        return total

    def grad_only(b):
        model.zero_grad(set_to_none=True)
        loss_value(b).backward()

    def full_step(b):
        return step(optimizer, b, 1.0, 4.0, LOSS_WEIGHTS["bit_budget"],
                    LOSS_WEIGHTS["smoothness"], LOSS_WEIGHTS["distillation"],
                    LOSS_WEIGHTS["regularization"], quantize=True, use_kd=False)

    progs = {"backbone_ms": lambda b: backbone_train(b["image"]),
             "morph_cum_ms": lambda b: morph_train(b["image"]),
             "fwd_train_ms": lambda b: fwd_train(b["image"]),
             "loss_only_ms": loss_value, "grad_ms": grad_only, "full_step_ms": full_step}
    # in turns, each stage the median of its per-round difference: the host's
    # pace drifts between programs timed one after the other by more than
    # the optimizer takes
    rounds = interleaved_ms(progs, batch_d, iters, device=device)
    t = {k: statistics.median(v) for k, v in rounds.items()}
    if kd:
        teacher = YOLOv8(variant, 80, device=device, seed=2)
        with torch.no_grad():
            t["teacher_fwd_ms"] = timed(teacher, images, iters=iters, device=device) * 1e3

    names = list(progs)
    stages = {"backbone_fwd": t["backbone_ms"]}
    for stage, later, earlier in zip(
            ("morphology", "quantize_neck_head_fwd", "tal_loss", "backward",
             "optimizer_projection"), names[1:], names[:-1]):
        stages[stage] = paired_median_ms(rounds, later, earlier)
    if kd:
        stages["teacher_fwd_kd_increment"] = t["teacher_fwd_ms"]

    # ---- roofline of the whole step: its inputs are the batch, the model's
    # state and the AdamW moments, as the reference's jitted step takes them
    state = list(model.state_dict().values()) + [
        v for s in optimizer.opt.state.values() for v in s.values()]
    c = program_cost(full_step, batch_d, state=state)
    gflops = c["flops"] / 1e9
    gb_floor = c["floor_bytes"] / 1e9
    t_flops = gflops / peak_tflops
    t_bytes = gb_floor / peak_gbps * 1e3
    bound = max(t_flops, t_bytes)
    return {
        "config": {"variant": variant, "batch": batch, "img": img, "iters": iters,
                   "peak_tflops": peak_tflops, "peak_gbps": peak_gbps, "kd": kd,
                   "amp": str(amp_dtype), **device_stamp(device)},
        "raw_ms": t,
        "stages_ms": stages,
        "stages_pct": {k: 100 * v / t["full_step_ms"] for k, v in stages.items()},
        "imgs_per_sec": batch / t["full_step_ms"] * 1e3,
        "step_gflops": gflops,
        "step_gb_floor": gb_floor,
        "step_bound_ms": bound,
        "bound_by": "flops" if t_flops >= t_bytes else "bytes",
        "pct_of_bound": 100 * bound / t["full_step_ms"],
        "achieved_tflops": gflops / t["full_step_ms"],
        "mfu_pct_bf16_peak": gflops / t["full_step_ms"] / peak_tflops * 100,
        "step_ops": c["ops"],
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--variant", default="yolov8m")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--img", type=int, default=640)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--peak-tflops", type=float, default=BF16_TENSOR_OPS_PER_S / 1e12)
    p.add_argument("--peak-gbps", type=float, default=HBM_BYTES_PER_S / 1e9)
    p.add_argument("--kd", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = resolve_device(None)  # CUDA, or raise
    res = run(args.variant, args.batch, args.img, args.iters, args.peak_tflops,
              args.peak_gbps, kd=args.kd, device=device)
    s = json.dumps(res, indent=2)
    print(s)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s + "\n")


if __name__ == "__main__":
    main()
