#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (`mcaq_yolo_tpu_torch`) on one
NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. environment: the card's name and power limit (nvidia-smi), TF32 off
     for the parity phases, build every CUDA kernel from csrc/ (nvcc, all
     sources at once);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (yolov8n at 640 px, bs=32: P3 80x80x64, P4
     40x40x128, P5 20x20x256) in float32 and bfloat16, with and without the
     soft mask, plus a non-multiple tile shape, yolov8m's P3 (C=192: 24
     groups of 8 channels, not a power of two), P3 at bs=256, and edge
     inputs (constant channels, subnormal and huge x, a frozen range that
     x overflows, bit maps on the rint ties 1.5 .. 8.5) — bitwise
     equality, one launch counted per call;
  3. the deployed program: a seeded random MCAQ-YOLOv8n (nc=80, MLP bit
     mapper, softplus) written as a flax msgpack checkpoint + meta, served
     by `Predictor(model_path)` at 640 px in bfloat16 (pool 256, conf 0.25,
     IoU 0.45, max_det 300) over three batches of 8 letterboxed images;
     kernel launch counts are reset just before and read just after, and
     one forward with quant_backend='torch' must give bitwise-equal raw
     maps;
  4. timings with CUDA events (median of 21): the device time of the
     kernel and of its plain version (with the soft mask and without), the
     per-channel min/max pass, the kernel's bound and its launch's waves
     over the SMs, per scale at bs=32 bf16 (8 launches back to back on
     distinct copies of the input, a working set larger than L2, queued
     behind a device sleep so the host's enqueue time is not counted),
     plus the kernel's host-paced time and host time per call; the
     deployed program's images/s at bs=32 and bs=256 (host included, as a
     caller sees it); the morphology stage's share of a forward;
  5. training: a seeded float32 YOLOv8n teacher written as a flax msgpack;
     `Trainer` (bf16 convolutions with float32 weights, KD on) over three
     one-batch epochs at 640 px, nc 80, bs 16, on seeded synthetic batches
     (128 box slots, 5-30 boxes per image): Stage 1 (no quantization,
     temperature 10), then Stage 3 (fractional compose).  Checked: finite
     losses, nonzero gradients reaching backbone, complexity MLP, bit mapper
     and all three soft masks, two EMA steps per quantizer, avg_bits in
     [2, 8], no kernel launch in training.  Then `calibrate` over 2 batches
     (3 launches each) and freeze; `save_checkpoint`; `Predictor` serves 8
     images from it (3 launches) and phase 3's kernel-versus-plain raw-map
     check repeats on the trained model.  The train step's wall ms and
     images/s, its split into student forward / teacher / loss / backward /
     optimizer (CUDA events), peak memory and the device's idle share over two steps
     (torch.profiler); one float32 step at 128 px, bs 2, on the card and
     on the CPU from the same weights and batch (TF32 off), compared.

Output: JSON lines; before the last, the `{"kernels": [...]}` summary; the
last line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside the repository, it exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "mcaq_yolo_tpu_torch/csrc/spatial_quant.cu"
REPLACES = "mcaq_yolo_tpu/ops/pallas_quant.py:247"
SCALES = (("P3", 80, 64, 10), ("P4", 40, 128, 10), ("P5", 20, 256, 5))
IMG = 640


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase_environment():
    import torch

    from mcaq_yolo_tpu_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        print(f"gpu: {line.strip()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    libs = build.build_all()
    ptxas = [ln.strip() for n in libs for ln in build.build_log(n).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "tf32": False,
          "build_s": round(time.perf_counter() - t0, 3),
          "kernels": sorted(libs), "ptxas": ptxas[:8]})
    return smi.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def quant_cases(device):
    """Phase 2's inputs, made one case at a time from seeds: (name, tiles,
    make) with make() -> (x float32 (B, H, W, C), bit map (B, Ht, Wt), mask
    (B, H, W), (x_min, x_max) or None to take the range from x)."""
    import torch

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def normal(shape, seed, scale=1.0):
        return torch.randn(shape, generator=gen(seed), device=device) * scale

    def uniform(shape, seed, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen(seed), device=device) * (hi - lo) + lo

    def case(B, H, C, t, seed, x=None, bits=None, rng=None):
        def make():
            xx = normal((B, H, H, C), seed) if x is None else x(B, H, C, seed)
            # continuous bit maps exercise the in-kernel round and clip
            bb = uniform((B, t, t), seed + 1, 1.5, 8.5) if bits is None else bits(B, t, seed)
            return xx, bb, uniform((B, H, H), seed + 2), rng(C) if rng else None
        return (B, H, H, C), (t, t), make

    def constant_channels(B, H, C, seed):
        xx = normal((B, H, H, C), seed)
        xx[..., :4] = torch.tensor([0.75, -3.0, 0.0, 1e-30], device=device)
        return xx  # range 0 on those channels: clamped to 1e-8

    def tiny(B, H, C, seed):
        xx = normal((B, H, H, C), seed, 1e-39)  # subnormal in f32 and bf16
        xx[0, 0, 0, : C // 2] = 1.0  # half the channels get a normal range
        return xx

    def ties(B, t, seed):
        k = torch.randint(1, 9, (B, t, t), generator=gen(seed), device=device)
        return k.float() + 0.5  # 1.5 .. 8.5: rint rounds half to even

    def narrow(C):  # a frozen calibration range far inside x's
        return (torch.full((C,), -0.01, device=device), torch.full((C,), 0.01, device=device))

    cases = [(name, *case(32, h, c, t, seed=10 * i)) for i, (name, h, c, t) in enumerate(SCALES)]
    cases += [
        ("non-multiple", *case(4, 12, 24, 5, seed=40)),
        ("constant-channel", *case(4, 40, 128, 10, seed=50, x=constant_channels)),
        ("tiny-subnormal", *case(4, 20, 256, 5, seed=60, x=tiny)),
        ("large", *case(4, 40, 128, 10, seed=70,
                        x=lambda B, H, C, s: normal((B, H, H, C), s, 1e36))),
        ("overflowing-quotient", *case(4, 20, 256, 5, seed=80, rng=narrow,
                                       x=lambda B, H, C, s: normal((B, H, H, C), s, 1e37))),
        ("bit-ties", *case(4, 80, 64, 10, seed=90, bits=ties)),
        ("yolov8m-P3", *case(32, 80, 192, 10, seed=100)),  # C/8 = 24 groups
        ("bs256-P3", *case(256, 80, 64, 10, seed=110)),
    ]
    return cases


def phase_kernel_vs_plain(device) -> float:
    import torch

    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq

    worst = 0.0
    n_cases = 0
    for name, shape, tiles, make in quant_cases(device):
        x32, bits, mask_in, rng = make()
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            if rng is None:
                lo, hi = torch.aminmax(x.reshape(-1, x.shape[-1]), dim=0)
                lo, hi = lo.float().contiguous(), hi.float().contiguous()
            else:
                lo, hi = rng
            for mask in (None, mask_in):
                before = sq.spatial_quantize.launches
                a = sq.spatial_quantize(x, bits, lo, hi, mask)
                b = sq.spatial_quantize_torch(x, bits, lo, hi, mask)
                torch.cuda.synchronize()
                check(sq.spatial_quantize.launches == before + 1,
                      "one spatial_quantize call must count one launch")
                ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                mism = int((a.view(ibits) != b.view(ibits)).sum())
                err = float((a.float() - b.float()).abs().max())
                finite = bool(torch.isfinite(a).all())
                worst = max(worst, err)
                n_cases += 1
                emit({"phase": "kernel_vs_plain", "kernel": "spatial_quant", "case": name,
                      "shape": list(shape), "tiles": list(tiles), "dtype": str(dtype),
                      "mask": mask is not None, "mismatches": mism, "max_abs_err": err,
                      "finite": finite, "tolerance": "bitwise"})
                check(mism == 0 and finite,
                      f"spatial_quant differs from its plain version: {name} {dtype} "
                      f"mask={mask is not None}: {mism} elements (finite: {finite})")
        del x32, bits, mask_in, x, a, b
    emit({"phase": "kernel_vs_plain", "cases": n_cases, "all_bitwise": True})
    return worst


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------


def serving_images(seed: int, count: int):
    """`count` x 8 seeded uint8 RGB images of mixed sizes (letterbox runs)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = [(480, 640), (640, 480), (720, 1280), (500, 500), (360, 640), (640, 640),
             (427, 640), (1024, 768)]
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(count)
            for h, w in sizes]


def seeded_model(device, dtype, seed: int = 0):
    """Random MCAQ-YOLOv8n (nc=80) from `seed`, with its bit mapper's
    BatchNorm statistics taken from the model's own complexity maps on
    seeded images and its output layer steepened, so that a random init
    spreads tiles over several bit widths (an untrained monotone MLP is
    nearly flat over the complexity range it sees)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mcaq_yolo_tpu_torch.data.dataset import letterbox
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.yolo import images_to_nchw

    model = MCAQYOLO(variant="yolov8n", num_classes=80, bit_mapping="mlp",
                     monotone_param="softplus", morph_downsample=2, dtype=dtype,
                     device=device, seed=seed)
    x = torch.from_numpy(np.stack([letterbox(im, IMG)[0] for im in
                                   serving_images(seed, count=1)[:4]])).to(device)
    mapper = model.bit_mapper
    with torch.no_grad():
        feats = model.backbone(images_to_nchw(x, dtype))
        c = torch.cat([model.complexity_analyzer(f.permute(0, 2, 3, 1)).reshape(-1)
                       for f in feats]).clamp(0.0, 1.0)[:, None]
        h = torch.cat([c, c ** 2, torch.log1p(c)], dim=-1)
        for i in range(mapper.n_hidden):
            h = mapper._dense(i)(h)
            bn = getattr(mapper, f"BatchNorm_{i}")
            bn.running_mean.copy_(h.mean(dim=0))
            bn.running_var.copy_(h.var(dim=0, unbiased=False))
            h = F.leaky_relu(bn(h), 0.05)
        last = mapper._dense(mapper.n_hidden)
        last.theta.copy_(torch.log(torch.expm1(F.softplus(last.theta) * 50.0)))
        # class outputs: scale each kernel so its logits spread with std ~1
        # (a random deep net's head input is so small that bf16 rounds the
        # spread away) and set its bias so ~k anchors per image clear conf
        # 0.25, giving decode + NMS real candidates
        feats = model.backbone(images_to_nchw(x, dtype))
        pyramid = model.neck(*[model.mcaq_transform(f, i, 1.0, True)[0]
                               for i, f in enumerate(feats)])
        for i, (f, k) in enumerate(zip(pyramid, (24, 12, 4))):
            head = model.head
            h = getattr(head, f"cls{i}_conv1")(getattr(head, f"cls{i}_conv0")(f))
            out = getattr(head, f"cls{i}_out")
            logits = F.conv2d(h.float(), out.weight.float())
            spread = logits.std()
            out.weight.div_(spread)
            best = (logits / spread).amax(dim=1).flatten(1)
            q = torch.quantile(best.flatten(), 1.0 - k / best.shape[1])
            out.bias.fill_(float(torch.logit(torch.tensor(0.25)) - q))
    return model


def phase_deployed_program(device, dtype, workdir: Path):
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.inference import Predictor
    from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint

    model = seeded_model(device, dtype)
    path = workdir / "mcaq_yolov8n.ckpt"
    meta = {
        "epoch": 0, "variant": "yolov8n", "num_classes": 80, "img_size": IMG,
        "deploy_temperature": 1.0,
        "config": {"quantization": {"min_bits": 2, "max_bits": 8, "target_bits": 4.0,
                                    "grid_size": 8, "bit_mapping": "mlp",
                                    "monotone_param": "softplus",
                                    "normalize_complexity": False},
                   "morphology": {"downsample": 2, "tile_engine": "lanes"}},
    }
    save_checkpoint(path, to_jax_variables(model), meta)
    del model

    pred = Predictor(str(path), conf_threshold=0.25, iou_threshold=0.45, max_det=300,
                     dtype=dtype, device=device)
    check(pred.pre_topk == 256 and pred.model.morph_downsample == 2, "meta not applied")
    images = serving_images(seed=1, count=3)

    sq.spatial_quantize.launches = 0
    t0 = time.perf_counter()
    results = pred.predict_batch(images, batch_size=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sq.spatial_quantize.launches
    forwards = 3

    check(len(results) == len(images), "predict_batch dropped images")
    bits = np.concatenate([r["bit_map"].ravel() for r in results])
    for r in results:
        check(2.0 <= r["avg_bits"] <= 8.0, f"avg_bits {r['avg_bits']} outside [2, 8]")
        check(np.isfinite(r["complexity_map"]).all(), "non-finite complexity")
        for d in r["detections"]:
            check(np.isfinite(d["bbox"]).all() and np.isfinite(d["confidence"]),
                  "non-finite detection")
    check(len(np.unique(bits)) > 1, "bit map is constant")
    check(launches == 3 * forwards,
          f"spatial_quant launched {launches} times in {forwards} forwards (expected 3 each)")
    emit({"phase": "deployed_program", "images": len(images), "batches": forwards,
          "batch_size": 8, "img_size": IMG, "dtype": str(dtype), "wall_s": round(wall, 3),
          "launches": {"spatial_quant": launches},
          "avg_bits": [round(r["avg_bits"], 4) for r in results[::8]],
          "bit_widths_seen": sorted(float(b) for b in np.unique(bits)),
          "detections": sum(len(r["detections"]) for r in results),
          "pool_saturations": pred.pool_saturations})

    backend_parity(pred, images[:8], device, "backend_parity")
    return pred, launches


def backend_parity(pred, images, device, phase: str) -> None:
    """One forward through the kernel and one through its plain version on
    the same letterboxed images: the raw maps must be bitwise equal."""
    import numpy as np
    import torch

    x = torch.from_numpy(np.stack([pred.preprocess(im)[0] for im in images])).to(device)
    with torch.inference_mode():
        raw_k, _ = pred.model(x)
        pred.model.set_quant_backend("torch")
        raw_p, _ = pred.model(x)
        pred.model.set_quant_backend("auto")
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(raw_k, raw_p))
    finite = all(bool(torch.isfinite(a).all()) for a in raw_k)
    emit({"phase": phase, "raw_maps_bitwise_equal": same, "finite": finite,
          "shapes": [list(a.shape) for a in raw_k]})
    check(same and finite, f"{phase}: raw maps differ between quant_backend 'auto' and "
                           "'torch'")


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------


def phase_timings(pred, device, dtype):
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.models.yolo import images_to_nchw
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.utils.cuda_timing import (
        COPIES, cuda_ms, host_us_per_call, quant_bound_ms, quant_bytes)

    torch.backends.cudnn.deterministic = False
    model = pred.model
    rng = np.random.default_rng(2)
    x32 = torch.from_numpy(rng.integers(0, 256, (32, IMG, IMG, 3), dtype=np.uint8)).to(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = sq.blocks_per_sm(dtype)

    rows = []
    with torch.inference_mode():
        feats = model.backbone(images_to_nchw(x32, dtype))
        for (name, _, _, _), f, q in zip(SCALES, feats, model.quantizers):
            xf = f.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            bit_map = model.bit_mapper(model.complexity_analyzer(xf), 1.0).float().contiguous()
            lo, hi = q.calibration_range(xf)
            mask = q.soft_mask(bit_map, xf)[..., 0].contiguous()
            # COPIES distinct inputs, cycled: the working set exceeds the
            # 50 MB L2, so every launch reads its input from HBM
            xs = [xf.clone() for _ in range(COPIES)]
            ms_ = [mask.clone() for _ in range(COPIES)]

            def kernel(k):
                return sq.spatial_quantize(xs[k], bit_map, lo, hi, ms_[k])

            geo = sq.launch_geometry(*xf.shape, xf.element_size())
            row = {
                "phase": "kernel_timing", "kernel": "spatial_quant", "scale": name,
                "shape": list(xf.shape), "dtype": str(dtype), "mask": True,
                "bytes": quant_bytes(xf, bit_map, mask),
                "ms": cuda_ms(kernel, inner=COPIES, device_only=True),
                "plain_ms": cuda_ms(
                    lambda k: sq.spatial_quantize_torch(xs[k], bit_map, lo, hi, ms_[k]),
                    inner=COPIES, device_only=True),
                "minmax_ms": cuda_ms(lambda k: q._batch_minmax(xs[k]), inner=COPIES,
                                     device_only=True),
                "bound_ms": quant_bound_ms(xf, bit_map, mask), "bound_by": "bytes",
                "unmasked_ms": cuda_ms(lambda k: sq.spatial_quantize(xs[k], bit_map, lo, hi),
                                       inner=COPIES, device_only=True),
                "unmasked_bound_ms": quant_bound_ms(xf, bit_map, None),
                "unmasked_plain_ms": cuda_ms(
                    lambda k: sq.spatial_quantize_torch(xs[k], bit_map, lo, hi),
                    inner=COPIES, device_only=True),
                "ms_host_paced": cuda_ms(kernel, inner=COPIES),
                "host_us_per_call": host_us_per_call(kernel),
                "blocks": geo.blocks, "pix_per_block": geo.pix_per_block,
                "blocks_per_sm": per_sm, "waves": geo.blocks / (sms * per_sm),
                "timing": f"device time of {COPIES} back-to-back launches on distinct "
                          "inputs queued behind a device sleep, median of 21; "
                          "ms_host_paced: the same without the sleep",
            }
            row["achieved_GBps"] = row["bytes"] / (row["ms"] * 1e-3) / 1e9
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["unmasked_bound_share"] = row["unmasked_bound_ms"] / row["unmasked_ms"]
            rows.append(row)
            emit(row)
            del xs, ms_

    def program(xb):
        return lambda k: pred._predict_device(xb)

    throughput = {}
    for bs in (32, 256):
        xb = x32 if bs == 32 else torch.from_numpy(
            rng.integers(0, 256, (bs, IMG, IMG, 3), dtype=np.uint8)).to(device)
        q1, ms, q3 = cuda_ms(program(xb), quartiles=True)
        throughput[bs] = bs / (ms * 1e-3)
        emit({"phase": "program_timing", "batch": bs, "img_size": IMG, "dtype": str(dtype),
              "ms_per_batch": ms, "ms_p25": q1, "ms_p75": q3, "images_per_s": throughput[bs],
              "program": "Predictor._predict_device (forward + decode + NMS, "
                         "pool 256, conf 0.25, max_det 300)",
              "peak_mem_GB": torch.cuda.max_memory_allocated(device) / 1e9})
        del xb

    with torch.inference_mode():
        feats = model.backbone(images_to_nchw(x32, dtype))

        def morph():
            for f in feats:
                model.bit_mapper(model.complexity_analyzer(
                    f.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)), 1.0)

        morph_ms = cuda_ms(lambda k: morph())
        fwd_ms = cuda_ms(lambda k: model(x32))
        bb_ms = cuda_ms(lambda k: model.backbone(images_to_nchw(x32, dtype)))
    emit({"phase": "forward_breakdown", "batch": 32, "forward_ms": fwd_ms,
          "backbone_ms": bb_ms, "morphology_and_mapper_ms": morph_ms,
          "morphology_share": morph_ms / fwd_ms})
    return rows, throughput


# ---------------------------------------------------------------------------
# Phase 5
# ---------------------------------------------------------------------------

TRAIN_BATCH = 16
TRAIN_GROUPS = ("backbone", "complexity_analyzer", "bit_mapper", "quantizer_p3",
                "quantizer_p4", "quantizer_p5")
LOSS_KEYS = ("loss_total", "loss_det", "box_loss", "cls_loss", "dfl_loss", "loss_bit",
             "loss_smooth", "loss_kd", "loss_reg")


def _grad_groups(model, scale: float = 1.0):
    """Per top-level group, the flattened gradient (times `scale`)."""
    import torch

    flat = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        flat.setdefault(name.split(".")[0], []).append(
            g.detach().float().cpu().reshape(-1) * scale)
    return {k: torch.cat(v) for k, v in flat.items()}


def phase_training(device, workdir: Path, img: int = IMG, batch: int = TRAIN_BATCH):
    """Train (bf16, KD from a seeded float32 teacher), calibrate, save, and
    serve the trained checkpoint through the kernel."""
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.calibrate import calibrate
    from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
    from mcaq_yolo_tpu_torch.inference import Predictor
    from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.train import Trainer
    from mcaq_yolo_tpu_torch.utils.checkpoint import write_msgpack

    tpath = workdir / "teacher.msgpack"
    tpath.write_bytes(write_msgpack(to_jax_variables(
        YOLOv8("yolov8n", 80, device="cpu", seed=1))))
    config = {
        "epochs": 3, "batch_size": batch, "learning_rate": 1e-3, "seed": 0,
        "output_dir": str(workdir / "train"),
        "model": {"name": "yolov8n", "num_classes": 80, "teacher_path": str(tpath)},
        "data": {"img_size": img, "max_boxes": 128}, "morphology": {"downsample": 2},
        "quantization": {"bit_mapping": "mlp", "monotone_param": "softplus"},
        # epoch 0: Stage 1 (no quantization, temperature 10); 1-2: Stage 3
        "curriculum": {"warmup_epochs": 0, "transition_epochs": 0},
        "scheduler": {"warmup_epochs": 1}, "distillation": {"enabled": True},
        "training": {"amp": True},
    }
    batches = synthetic_batches(1, batch, img, 80, max_boxes=128, boxes_per_image=(5, 30),
                                seed=3)
    trainer = Trainer(config, batches, device=device)
    check(trainer.amp_dtype == torch.bfloat16 or device.type != "cuda", "amp not bf16")

    sq.spatial_quantize.launches = 0
    t0 = time.perf_counter()
    epochs = [trainer.train_epoch(e) for e in range(3)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = sq.spatial_quantize.launches
    grads = _grad_groups(trainer.model)
    grad_norms = {k: float(v.norm()) for k, v in grads.items()}
    num_batches = [int(q.num_batches) for q in trainer.model.quantizers]
    emit({"phase": "training", "img_size": img, "batch": batch, "num_classes": 80,
          "dtype": "bfloat16 convolutions, float32 weights" if trainer.amp_dtype else "float32",
          "teacher": "float32", "wall_s": round(train_s, 3),
          "epochs": [{k: (round(v, 6) if isinstance(v, float) else v) for k, v in e.items()}
                     for e in epochs],
          "grad_norms_last_step": grad_norms, "quantizer_num_batches": num_batches,
          "launches": {"spatial_quant": train_launches}})
    check([int(e["stage"]) for e in epochs] == [1, 3, 3], "curriculum stages are not 1, 3, 3")
    check(epochs[0]["temperature"] == 10.0 and [e["quantize"] for e in epochs] == [0, 1, 1],
          "Stage 1 must run at temperature 10 without quantization")
    for e in epochs:
        check(all(np.isfinite(e[k]) for k in LOSS_KEYS), f"non-finite loss: {e}")
        check(2.0 <= e["avg_bits"] <= 8.0, f"avg_bits {e['avg_bits']} outside [2, 8]")
    for k in TRAIN_GROUPS:
        check(grad_norms.get(k, 0.0) > 0.0, f"no gradient reached {k}")
    check(num_batches == [2, 2, 2], f"quantizer EMA steps {num_batches}, expected 2 each")
    check(train_launches == 0, "the training forward ran the eval kernel")

    calib = synthetic_batches(2, batch, img, 80, seed=4)
    sq.spatial_quantize.launches = 0
    calibrate(trainer.model, calib, num_images=2 * batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    calib_launches = sq.spatial_quantize.launches
    stats = [(int(q.num_batches), bool(q.frozen)) for q in trainer.model.quantizers]
    emit({"phase": "calibration", "batches": 2, "quantizer_state": stats,
          "launches": {"spatial_quant": calib_launches}})
    check(stats == [(4, True)] * 3, f"calibration state {stats}")
    check(calib_launches == 3 * 2, f"spatial_quant launched {calib_launches} times in "
                                   "2 calibration forwards (expected 3 each)")

    path = trainer.save_checkpoint("trained.ckpt", 2)
    pred = Predictor(str(path), conf_threshold=0.25, iou_threshold=0.45, max_det=300,
                     dtype=torch.bfloat16, device=device)
    check(all(bool(q.frozen) for q in pred.model.quantizers), "frozen stats not served")
    images = serving_images(seed=5, count=1)
    sq.spatial_quantize.launches = 0
    results = pred.predict_batch(images, batch_size=8)
    if device.type == "cuda":
        torch.cuda.synchronize()
    serve_launches = sq.spatial_quantize.launches
    emit({"phase": "trained_serving", "images": len(results), "batch_size": 8,
          "avg_bits": round(results[0]["avg_bits"], 4),
          "detections": sum(len(r["detections"]) for r in results),
          "launches": {"spatial_quant": serve_launches}})
    for r in results:
        check(2.0 <= r["avg_bits"] <= 8.0 and np.isfinite(r["complexity_map"]).all(),
              "trained model served a bad result")
        for d in r["detections"]:
            check(np.isfinite(d["bbox"]).all(), "non-finite detection")
    check(serve_launches == 3, f"spatial_quant launched {serve_launches} times in one "
                               "forward of the trained model (expected 3)")
    backend_parity(pred, images, device, "trained_backend_parity")
    return trainer, {"training": train_launches, "calibration": calib_launches,
                     "trained_serving": serve_launches}


def phase_train_timing(trainer, device, reps: int = 5):
    """The bs=16 bf16 KD train step: wall ms (host clock around a
    synchronised step, median of `reps`), its split into the student's
    forward, the teacher's, the loss with the assigner, backward and
    optimizer (CUDA events between the phases), peak memory, and the
    device's idle share over two steps (torch.profiler: union of kernel
    intervals against the host's wall time, profiled and unprofiled)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = trainer._to_device(trainer.train_loader[0])
    e = 2
    w = trainer.curriculum.get_loss_weights(e)
    args = (trainer.curriculum.get_effective_temperature(e), trainer.curriculum.get_target_bits(e),
            w["bit_budget"], w["smoothness"], w["distillation"], w["regularization"])

    def step(mark=None):
        return trainer.train_step(trainer.optimizer, batch, *args, quantize=True, use_kd=True,
                                  mark=mark)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    walls, splits = [], []
    for _ in range(reps):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        t0 = time.perf_counter()
        step(mark)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        splits.append({b[0]: a[1].elapsed_time(b[1]) for a, b in zip(events, events[1:])})
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for ev in sorted(kernels, key=lambda ev: ev.time_range.start):
        s_, e_ = ev.time_range.start, ev.time_range.end
        busy_us += max(0.0, e_ - max(s_, end))
        end = max(end, e_)
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (e_ - s_)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ms = statistics.median(walls)
    row = {"phase": "train_step_timing", "batch": TRAIN_BATCH, "img_size": IMG,
           "dtype": "bfloat16 convolutions, float32 weights; float32 teacher; TF32 off",
           "ms_per_step": ms, "ms_min": min(walls), "ms_max": max(walls),
           "images_per_s": TRAIN_BATCH / (ms * 1e-3),
           "split_ms": split, "split_sum_ms": sum(split.values()),
           "peak_mem_GB": peak_gb,
           "profiled_steps": 2, "profiled_wall_ms": prof_wall_us / 1e3,
           "kernel_events": len(kernels),
           "device_busy_ms": busy_us / 1e3 if kernels else None,
           "idle_share": (1.0 - busy_us / prof_wall_us) if kernels else None,
           # the profiler slows the host, not the kernels: the busy time per
           # step against the unprofiled step's wall time
           "idle_share_unprofiled_step": (1.0 - busy_us / 2e3 / ms) if kernels else None,
           "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top],
           "timing": "wall: host clock around a synchronised step, median of "
                     f"{reps}; split: CUDA events between phases, median"}
    emit(row)
    return row


def phase_step_cuda_vs_cpu(device, img: int = 128, batch: int = 2):
    """One float32 train step (Stage 3, KD) at `img` px on the card and on
    the CPU from the same seeded weights and batch, TF32 off: loss terms
    within 1e-3 relative, each group's gradient within 1e-2 relative L2."""
    import torch

    from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
    from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
    from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must be off for the CUDA-versus-CPU step")
    data = synthetic_batches(1, batch, img, 80, max_boxes=128, boxes_per_image=(5, 30),
                             seed=6)[0]
    runs = {}
    for dev in (torch.device("cpu"), device):
        model = MCAQYOLO(num_classes=80, morph_downsample=2, device=dev, seed=0)
        teacher = YOLOv8("yolov8n", 80, device=dev, seed=1)
        step = make_train_step(model, MCAQYOLOLoss(80, 4.0), teacher)
        opt = Optimizer(model, lambda s: 0.0)  # lr 0: the weights stay
        m = step(opt, {k: torch.from_numpy(v).to(dev) for k, v in data.items()}, 1.0, 4.0,
                 0.05, 0.1, 0.5, 1e-4, quantize=True, use_kd=True)
        # the step clipped the gradients to norm 1; scale them back
        runs[dev.type] = ({k: float(m[k]) for k in LOSS_KEYS},
                          _grad_groups(model, max(float(m["grad_norm"]), 1.0)))
    (l_cpu, g_cpu), (l_dev, g_dev) = runs["cpu"], runs[device.type]
    loss_rel = {k: abs(l_dev[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in LOSS_KEYS}
    grad_rel = {k: float((g_dev[k] - g.float()).norm() / g.norm()) for k, g in g_cpu.items()
                if float(g.norm()) > 0}
    emit({"phase": "step_cuda_vs_cpu", "img_size": img, "batch": batch, "dtype": "float32",
          "tf32": False, "loss_rel_err": loss_rel, "grad_rel_l2_err": grad_rel,
          "tolerance": "loss terms 1e-3 relative; gradient per group 1e-2 relative L2"})
    check(set(grad_rel) == set(g_cpu), "a group got no gradient on the CPU")
    check(max(loss_rel.values()) <= 1e-3, f"loss terms differ: {loss_rel}")
    check(max(grad_rel.values()) <= 1e-2, f"gradients differ: {grad_rel}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / KERNEL_SOURCE).is_file():
        print(f"chip_smoke: {KERNEL_SOURCE} not found; run from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda")
    dtype = torch.bfloat16

    phase_environment()
    worst = phase_kernel_vs_plain(device)
    scratch = ROOT / "build"  # gitignored; the run writes nothing outside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        pred, launches = phase_deployed_program(device, dtype, Path(tmp))
        rows, _ = phase_timings(pred, device, dtype)
        del pred
        trainer, path_launches = phase_training(device, Path(tmp))
        phase_train_timing(trainer, device)
        del trainer
    phase_step_cuda_vs_cpu(device)

    emit({"kernels": [{
        "name": "spatial_quant", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
        "library_ms": None,
        "launches_by_path": dict(deployed=launches, **path_launches),
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
