#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (`mcaq_yolo_tpu_torch`) on one
NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. environment: the card's name and power limit (nvidia-smi), TF32 off
     for the parity phases, build every CUDA kernel (nvcc) and the host
     letterbox library (g++) from csrc/, all sources at once;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (yolov8n at 640 px, bs=32: P3 80x80x64, P4
     40x40x128, P5 20x20x256) in float32 and bfloat16, with and without the
     soft mask, plus a non-multiple tile shape, yolov8m's P3 (C=192: 24
     groups of 8 channels, not a power of two), P3 at bs=256, and edge
     inputs (constant channels, subnormal and huge x, a frozen range that
     x overflows, bit maps on the rint ties 1.5 .. 8.5) and per-bit range
     rows (7, C) at P3 / P4 / P5 and (7, 1) at P4 (mse calibration's
     ranges), and RT-DETR-L's taps at bs 256 (80x80x512, 40x40x1024,
     20x20x2048) — bitwise equality, one launch counted per call; then the
     RT-DETR taps timed in bfloat16 with the soft mask (device ms beside
     the bytes' bound at 3.35 TB/s);
 2b. the phi kernel (csrc/morph_tiles.cu, the 'lanes' tile engine) against
     its plain version on 28 gray maps — every tile 1-128 (random, and with
     constant, zero and exactly tied tiles), a random YOLOv8n's P3 / P4 / P5
     features at 640 px (downsample 1 and 2) and its P5 at 64 and 32 px,
     letterboxed images at 128, 256, 640 and 1280 px (Eq.(8) scoring's
     tiles) — in all 8 option combinations: bitwise against the plain
     version on the card; against the CPU's plain version within 1e-5 on
     all but 0.1% of the tiles, each such tile traced to its edge map or
     mask; one launch counted per call.  A letterboxed 2048-px image (tile
     256) in every option too: bitwise but for a tile whose Otsu bin the
     plain version's rounded float sums moved (`otsu_bins_differ`), each
     such tile counted; one launch a call.  Every later path zeroes both
     kernels' launch counts just before it runs and reads them just after
     (one phi launch per scale of every forward that runs the analyzer);
 2c. the eval BatchNorm + SiLU kernel (csrc/bn_silu.cu) at every SiLU
     ConvBnSiLU shape of a 640-px forward of YOLOv8n, YOLOv8m, RT-DETR-L
     (its 12) and YOLO12-L (its 141, 16 of them 307 channels wide: the
     kernel's element path) at bs 256 in bfloat16 (the serving cells) and
     of YOLOv8m at
     bs 64 in float32 (the KD teacher of the training cell): bitwise
     against F.batch_norm +
     F.silu with ATen's channels-last BatchNorm (cuDNN off) on each
     distinct shape, the largest gap measured (abs and in ulps; abs against
     the library's default, cuDNN's float32 BatchNorm), then its
     device ms a forward (the shapes' times summed; each map rewritten in
     place by back-to-back launches, over 8 distinct copies in turn where
     a map is smaller than the 50 MB L2 cache), the bytes' bound at 3.35
     TB/s and its share of it, and `library_ms`, F.batch_norm + F.silu (the
     yardstick and the plain version; the port calls it off the card);
     every later path reads the kernel's launches beside the phi kernel's,
     one a ConvBnSiLU of every eval forward (the KD teacher's in training);
  2d. the training quantize's kernel pair (csrc/frac_quant.cu) at the
     training cell's three maps (YOLOv8m at 640 px, ds 1, bs 64, bfloat16,
     the soft mask on): forward and grad x bitwise the plain path's
     (compose_fractional with autograd), grad frac and grad mask within
     1e-5 relative L2, 2 launches a map; then the device ms of the forward
     (without gradient), of the backward (autograd.grad on a kept graph)
     and of the plain path's forward + backward, each map over 8 distinct
     copies where it is smaller than the L2 cache, beside the bytes' bound
     at 3.35 TB/s; every later path reads the pair's launches beside the
     phi kernel's: 0 on an eval, calibration or serving path, a forward and
     a backward a quantizer in each quantized training step on the card
     (12 in phase 5's two Stage-3 steps, 6 in its CUDA-versus-CPU step,
     6 a step from Stage 2 on in phase 6's training from disk);
  2e. the float32 convolution kernel (csrc/conv_f32.py, Triton, 3xTF32) at
     the KD teacher's 35 shapes (YOLOv8m's 77 ConvBnSiLU at bs 64, 640 px):
     one launch counted a call, a channels-last output, and at each shape
     its relative L2 gap to a float64 F.conv2d at most 2x cuDNN float32's
     (TF32 off) and 100x below cuDNN TF32's; the device ms of the kernel,
     the plain version and cuDNN float32 (`library_ms`) summed over the 77
     beside the bound at 165 TFLOP/s (495 / 3); then a whole teacher
     forward at bs 64 (77 launches, its device ms beside cuDNN's) against
     a float64 teacher: C3/C4/C5 held to both, the raw maps (a seeded
     head's biases, float32's rounding) to the 2x alone, and the raw maps
     with the head's six output biases zeroed (the convolutions' own
     output) to both; every later path reads the kernel's launches beside
     the phi kernel's: 0 on a bf16 path, one a ConvBnSiLU of every forward
     of a float32 network without autograd (the KD teacher's in each
     training step, a float32 model's calibration, validation loss and
     served forwards);
  3. the deployed program: a seeded random MCAQ-YOLOv8n (nc=80, MLP bit
     mapper, softplus) written as a flax msgpack checkpoint + meta, served
     by `Predictor(model_path)` at 640 px in bfloat16 (pool 256, conf 0.25,
     IoU 0.45, max_det 300) over three batches of 8 letterboxed images;
     kernel launch counts are reset just before and read just after, and
     one forward with quant_backend='torch' must give bitwise-equal raw
     maps; then a seeded MCAQ RT-DETR-L (conf 0.25, max_det 300, NMS-free)
     and a seeded MCAQ YOLO12-L (conf 0.25, IoU 0.45, max_det 300), each
     served the same way from its own checkpoint over one batch of 8: 3
     spatial_quant and 3 phi_tiles launches a call, and 12 bn_silu
     launches (RT-DETR-L) or 141 with 16 area attentions (YOLO12-L), all
     counted from zero just before the call; then each one's raw maps
     bitwise equal through the kernel and its plain version;
  4. the kernels alone, timed with CUDA events (median of 21; the
     program's own times are the benchmark's, `python3 -m perfbench.run`):
     the device time of the kernel and of its plain version (with the soft
     mask and without), the per-channel min/max pass, the kernel's bound
     and its launch's waves over the SMs, per scale at bs=32 bf16 (8
     launches back to back on distinct copies of the input, a working set
     larger than L2, queued behind a device sleep so the host's enqueue
     time is not counted), plus the kernel's host-paced time and host time
     per call; decode + NMS alone on the served raw maps at bs 32 and 256
     with the eager keep loop and with the `while_loop` one that export
     traces, bitwise equal (not timed); the phi kernel per scale at bs 32
     and 256 (device ms, plain ms, bound) and, at bs 32, the CUDA kernels of one
     scale's phi with its gray preparation (at most 16) with each engine;
     the same timing for P3 at downsample 1 (tile 8, bs 32) and for Eq.(8)
     scoring's maps (bs 8 letterboxed images: tile 64 at 640 px, 128 at
     1280 px, 256 at 2048 px);
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
     check repeats on the trained model.  Then one float32 step at 128 px,
     bs 2, on the card and on the CPU from the same weights and batch (TF32
     off), compared;
  6. training from disk: a v3 synthetic dataset of 128 train and 32 val
     images at 640 px written under build/, a seeded float32 teacher, then
     `Trainer(config, device="cuda").train()` from data.train / data.val
     (yolov8n, nc 80, bs 16, bf16, KD, morphology.downsample 2, curriculum
     warm-up 1 and transition 2 over 5 epochs: stages 1, 1, 2, 3, 3).
     Checked: the stages; the epoch-0 tau_t subset smaller than the split
     (after the warm-up tau_t is 1.0, so later epochs take the whole split);
     the Eq.(8) scores cached and deterministic; the Stage-2 refit moved
     feature_weights onto the simplex; finite losses and val_loss every
     epoch; from Stage 2 finite mAP@0.5 and mAP@[.5:.95] with avg_bits in
     [2, 8]; spatial_quant launches in evaluate and in the validation loss
     equal 3 x the quantized eval forwards counted by a forward hook;
     best.ckpt, last.ckpt and history.json; a fresh Trainer resumed from
     last.ckpt equal bitwise in every model tensor, AdamW moment and
     count; Predictor serving best.ckpt with 3 launches and raw maps
     bitwise equal to the plain path's; one epoch with
     data.device_pipeline: true with finite losses, its bank bitwise equal
     to the host loader's clean images and every augmentation firing (HSV
     changes pixels, the affine moves boxes).  Timed (host clock, card name
     and power limit beside): dataset write, scoring, each epoch, the host
     loader and the device pipeline alone, training and evaluate images/s,
     and the card's idle share over one epoch (torch.profiler);
  7. deploying a model trained elsewhere, yolov8n, nc 80, 640 px: (a) an
     Ultralytics-layout YOLOv8n (tests/torch_yolo_fixture.py, seeded)
     converted by `load_pretrained_into`, its C3/C4/C5 and raw maps in
     float32 (TF32 off) against the fixture's forward; (b) for each
     calibration mode (minmax, percentile, entropy, mse) `calibrate` over
     4 batches of 32 images in bf16 (12 launches), freeze, save, and one
     eval forward bitwise between the kernel and the plain version (3
     launches; percentile at bs 64, mse through (7, C) rows); (c)
     `Predictor` serves the minmax checkpoint (3 launches, bitwise); (d)
     `export_inference` at bs 32 with NMS, saved, loaded, bitwise equal to
     the eager program, 3 op nodes, 3 launches per call, both timed; (e)
     the inference CLI on 16 PNGs in a process of its own, its launches
     counted there (6 in the warm-up, 3 in its one chunk) and its wall time
     split, its JSON against `predict_batch`; (f) `curriculum.score_backend:
     cv2` scores 16 of phase 6's images equal to `score_image_cv2`;
  8. the evidence scripts on phase 6's best.ckpt and its 32-image val
     split at 640 px: (a) `apply_external_bit_maps` with the model's own
     bit maps equals the normal quantized forward bitwise, in 3 launches;
     (b) permuted and constant maps give bitwise-equal raw maps through the
     kernel (3 launches) and the plain version (0); (c) `m3_permutation`,
     `m4_variation_gain` (200 bootstrap reps, no figure),
     `downsample_fidelity` and `pretopk_equivalence` end with finite
     numbers, each with 3 launches per quantized forward and the forwards
     its batches imply; (d) `batched_nms` over `decode_predictions` equals
     `decode_and_nms` at the same gate and pool (conf 0.001 and 1e-7, pool
     1024: the same valid set and classes, boxes and scores within 1e-6
     relative), both timed;
  9. diagnostics (the profiling layer and the morphology options, each
     path's spatial_quant launches counted): `component_breakdown` with
     FLOPs and byte floors at bs 32 and 256 (640 px, bf16), its `with_mcaq`
     features bitwise equal to the forward's through the kernel and the
     plain version; the bs-256 roofline, every stage's bound at most its
     time; a short batch sweep; the morphology operators at P3 / P4 / P5
     (bs 32) with their CUDA kernel counts; the yolov8n bs-16 train-step
     breakdown (its backward counted, its bound under its time); the
     backend-agreement arms at 16 images, 256 px; one trace with kernels;
 10. multi-device: two ranks that share the card over gloo (NCCL refuses
     two ranks on one GPU; a file store in the work directory), each a
     spawned process, against the one-rank program on the same global
     batches, float32 with TF32 off: 'dp' and 'fsdp' training over phase
     5's three one-batch epochs (bs 16 global, KD), with the first loss,
     the parameters' relative L2 and the BatchNorm statistics held to the
     stated bounds and fsdp's sharded fraction equal to the rule's;
     `Predictor(data_parallel=True)` on 32 images in chunks of 11 (12 per
     forward, the tail padded) with the same detections and confidences
     within rtol 2e-5 / atol 2e-6 and 3 launches per rank per forward;
     distributed `evaluate` of the serving model (phase 6's best.ckpt
     detects nothing there) on phase 6's 32 val images at Stage 3, labelled
     with the one-rank program's detections of score >= 0.25 so that the
     mAP moves with every detection, with the one-rank mAP (cuDNN off, as in
     serving's check) and 3 launches per rank per forward.
 11. the entry points and the train example: `entry()` (yolov8n, nc 80, MLP
     mapper, float32, seeded) and its fn on its (4, 3, 640, 640) zero images
     and on 4 letterboxed serving images, each call with 3 spatial_quant
     and 3 phi_tiles launches, raw maps bitwise equal to the same model
     with quant_backend='torch', finite outputs, timed; `dryrun_multichip(2)`
     (two spawned ranks sharing the card over gloo) with its three lines
     and each rank's launches per program (DP step 0 + 3, DP serving 3 + 3,
     FSDP step 0 + 3), its DP step's loss and avg_bits within 1e-3 relative
     of the same dryrun on two CPU ranks (TF32 off, the ranks inherit it);
     `examples/train_example_torch.py` end to end on the
     card (16 images, 128 px, 3 epochs, then one image served), its
     Trainer.train and Predictor.predict launches counted apart.
 12. the bench entry: `python -m mcaq_yolo_tpu_torch.bench` in a process
     of its own with a short budget (BENCH_TIME_BUDGET_S=180,
     BENCH_ITERS=8): rc 0, the headline first, bench.py's keys and metric
     name on the last line, every arm but torch_cpu_fallback measured (that
     one needs the reference's checkout: skipped with its reason), the
     card's name and power limit in `extra.device`, 3 spatial_quant and 3
     phi_tiles launches per forward of the headline program (the plain and
     train arms 0 + 3), 5 runs a measurement, a positive headline; the
     committed record is put back after.

Output: JSON lines; before the last, the `{"kernels": [...]}` summary
(spatial_quant, phi_tiles, bn_silu, frac_quant and conv_f32, each with
`launches_by_path`); the
last line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside the repository, it exits 2.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "mcaq_yolo_tpu_torch/csrc/spatial_quant.cu"
REPLACES = "mcaq_yolo_tpu/ops/pallas_quant.py:247"
PHI_SOURCE = "mcaq_yolo_tpu_torch/csrc/morph_tiles.cu"
PHI_REPLACES = "mcaq_yolo_tpu/core/morphology_lanes.py:395"
PHI_LAUNCHES = {}  # path -> phi_tiles launches in that path's run
BN_SILU_SOURCE = "mcaq_yolo_tpu_torch/csrc/bn_silu.cu"
FRAC_QUANT_SOURCE = "mcaq_yolo_tpu_torch/csrc/frac_quant.cu"
CONV_F32_SOURCE = "mcaq_yolo_tpu_torch/csrc/conv_f32.py"
CONV_F32_BATCH = 64  # the training cell's batch
CONV_F32_FLOPS = 495e12 / 3  # three TF32 products a multiply-add (H100 SXM, dense)
# (scale, H = W, C, Ht = Wt) of phase 2d: the training cell's maps, YOLOv8m
# at 640 px, ds 1, and its batch
FRAC_QUANT_MAPS = (("P3", 80, 192, 10), ("P4", 40, 384, 10), ("P5", 20, 576, 5))
FRAC_QUANT_BATCH = 64
BN_SILU_LAUNCHES = {}  # path -> bn_silu launches in that path's run
_BN_SILU_BASE = [0]  # the counter `bn_silu` at the last `zero_launches`
FRAC_QUANT_LAUNCHES = {}  # path -> frac_quant launches in that path's run
_FRAC_QUANT_BASE = [0]  # the counter `frac_quant` at the last `zero_launches`
CONV_F32_LAUNCHES = {}  # path -> conv_f32 launches in that path's run
_CONV_F32_BASE = [0]  # the counter `conv_f32` at the last `zero_launches`
# (variant, dtype, batch) of phase 2c: the serving cells' forwards and the
# training cell's float32 teacher
BN_SILU_FORWARDS = (("yolov8n", "bfloat16", 256), ("yolov8m", "bfloat16", 256),
                    ("yolov8m", "float32", 64), ("rtdetr-l", "bfloat16", 256),
                    ("yolo12l", "bfloat16", 256))
# variant -> (path, SiLU ConvBns, area attentions) of one call of phase 3's
# seeded checkpoints of the other families
FAMILY_CALLS = {"rtdetr-l": ("deployed_rtdetr", 12, 0),
                "yolo12l": ("deployed_yolo12", 141, 16)}
SCALES = (("P3", 80, 64, 10), ("P4", 40, 128, 10), ("P5", 20, 256, 5))
# (scale, H = W, C, Ht = Wt) of RT-DETR-L's taps (yaml layers 3, 7, 9) at
# 640 px, and the batch of its serving cell
RTDETR_TAPS = (("P3", 80, 512, 10), ("P4", 40, 1024, 10), ("P5", 20, 2048, 5))
RTDETR_BATCH = 256
IMG = 640


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def zero_launches() -> None:
    """The kernels' launch counts set to 0 (bn_silu's, frac_quant's and
    conv_f32's: their counters noted), just before a path runs."""
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.ops import bn_silu, conv_f32, frac_quant
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq

    sq.spatial_quantize.launches = 0
    ml.phi_tiles.launches = 0
    _BN_SILU_BASE[0] = bn_silu.launches()
    _FRAC_QUANT_BASE[0] = frac_quant.launches()
    _CONV_F32_BASE[0] = conv_f32.launches()


def phi_launches(path: str, expected=None, bn=None, fq=0, cf=0) -> int:
    """The phi kernel's launches since `zero_launches`, recorded as `path`'s;
    held to `expected` when given, else to at least one.  The eval
    BatchNorm + SiLU kernel's launches since then are recorded beside them,
    and held to `bn` when given (one a ConvBnSiLU of every eval forward on
    the card, `conv_bn_silu_modules`); so are the training quantize's, held
    to `fq` (default 0: an eval, calibration or serving path runs none; a
    training step on the card runs 6, a forward and a backward for each of
    the three quantizers, once quantization is on); and the float32
    convolution's, held to `cf` (default 0: a bf16 network runs none; a
    float32 one with nothing to differentiate, the KD teacher or a float32
    model in eval, one a ConvBnSiLU a forward)."""
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.ops import bn_silu, conv_f32, frac_quant

    n = PHI_LAUNCHES[path] = ml.phi_tiles.launches
    check(n == expected if expected is not None else n > 0,
          f"{path}: the phi kernel launched {n} times (expected "
          f"{expected if expected is not None else 'at least 1'})")
    b = BN_SILU_LAUNCHES[path] = bn_silu.launches() - _BN_SILU_BASE[0]
    check(bn is None or b == bn,
          f"{path}: the bn_silu kernel launched {b} times (expected {bn})")
    f = FRAC_QUANT_LAUNCHES[path] = frac_quant.launches() - _FRAC_QUANT_BASE[0]
    check(f == fq, f"{path}: the frac_quant kernels launched {f} times (expected {fq})")
    c = CONV_F32_LAUNCHES[path] = conv_f32.launches() - _CONV_F32_BASE[0]
    check(c == cf, f"{path}: the conv_f32 kernel launched {c} times (expected {cf})")
    return n


def takes_bn_silu(m) -> bool:
    """A SiLU ConvBnSiLU: the modules whose eval BatchNorm + SiLU the
    bn_silu kernel runs on the card (ReLU and activation-free ConvBns run
    F.batch_norm)."""
    from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU

    return isinstance(m, ConvBnSiLU) and m.act is True


def conv_bn_silu_modules(model) -> int:
    """SiLU ConvBnSiLU modules in `model`: the bn_silu launches of one eval
    forward on the card."""
    return sum(map(takes_bn_silu, model.modules()))


def _traced_conv_bn_silu(variant: str, batch: int, img_size: int, num_classes: int,
                         record) -> None:
    """A `variant`'s network forward (backbone, neck, head; any family) on a
    batch of img_size images on the meta device (so nothing
    is computed), calling record(module, input, output) at every SiLU
    ConvBnSiLU in forward order."""
    import torch

    from mcaq_yolo_tpu_torch.models.yolo import build_network

    with torch.device("meta"):
        backbone, neck, head = build_network(variant, num_classes)
    hooks = [m.register_forward_hook(lambda m, i, out: record(m, i[0], out))
             for part in (backbone, neck, head) for m in part.modules() if takes_bn_silu(m)]
    try:
        with torch.no_grad():
            x = torch.empty((batch, 3, img_size, img_size), device="meta")
            head(neck(*backbone(x.contiguous(memory_format=torch.channels_last))))
    finally:
        for h in hooks:
            h.remove()


def conv_bn_silu_shapes(variant: str, batch: int, img_size: int, num_classes: int = 80):
    """(N, C, H, W) of every SiLU ConvBnSiLU output in a `variant`'s
    network forward on a batch of img_size images, in forward order: the
    maps the bn_silu kernel runs over on the card."""
    shapes = []
    _traced_conv_bn_silu(variant, batch, img_size, num_classes,
                         lambda m, x, out: shapes.append(tuple(out.shape)))
    return shapes


def conv_bn_silu_convs(variant: str, batch: int, img_size: int, num_classes: int = 80):
    """(N, Cin, H, W, Cout, kernel, stride, padding) of every SiLU
    ConvBnSiLU's convolution in a `variant`'s network forward, in forward
    order: the convolutions the conv_f32 kernel runs for a float32 network
    on the card (YOLOv8m's 77 in 35 shapes, the KD teacher's)."""
    convs = []
    _traced_conv_bn_silu(variant, batch, img_size, num_classes, lambda m, x, out: convs.append(
        tuple(x.shape) + (m.Conv_0.out_channels, m.Conv_0.kernel_size[0],
                          m.Conv_0.stride[0], m.Conv_0.padding[0])))
    return convs


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
    libs = build.build_all(build.KERNELS + build.HOST_LIBRARIES)  # all compilers at once
    ptxas = [ln.strip() for n in build.KERNELS for ln in build.build_log(n).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "tf32": False,
          "build_s": round(time.perf_counter() - t0, 3),
          "kernels": list(build.KERNELS), "host_libraries": list(build.HOST_LIBRARIES),
          "built": sorted(libs), "ptxas": ptxas[:24]})
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

    def per_bit(width):
        """(7, width) ranges, one row per bit width (mse calibration's rows;
        width 1 is expanded to (7, C) by the wrapper)."""
        def rows(C):
            return (-uniform((7, width), 7 * C + width, 0.5, 3.0),
                    uniform((7, width), 7 * C + width + 1, 0.5, 3.0))
        return rows

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
    cases += [(f"per-bit-rows-{name}", *case(32, h, c, t, seed=120 + 10 * i, rng=per_bit(c)))
              for i, (name, h, c, t) in enumerate(SCALES)]
    cases += [("per-bit-global-P4", *case(4, 40, 128, 10, seed=150, rng=per_bit(1)))]
    cases += [(f"rtdetr-l-{name}", *case(RTDETR_BATCH, h, c, t, seed=160 + 10 * i))
              for i, (name, h, c, t) in enumerate(RTDETR_TAPS)]
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


def rtdetr_tap_timings(device) -> list:
    """spatial_quant at RT-DETR-L's three taps (bs 256, bfloat16, the soft
    mask on; seeded normal maps and bit maps over 2-8 bits): the kernel's
    device time (one launch a map larger than the 50 MB L2 cache, over
    COPIES distinct copies in turn otherwise), the plain version's, and
    the bytes' bound at 3.35 TB/s.  One row a tap."""
    import torch

    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.utils.cuda_timing import (COPIES, L2_BYTES, cuda_ms,
                                                       quant_bound_ms, quant_bytes)

    rows = []
    for i, (name, h, c, t) in enumerate(RTDETR_TAPS):
        g = torch.Generator(device=device).manual_seed(200 + i)
        x = torch.randn((RTDETR_BATCH, h, h, c), generator=g, device=device).to(torch.bfloat16)
        bits = torch.rand((RTDETR_BATCH, t, t), generator=g, device=device) * 7.0 + 1.5
        mask = torch.rand((RTDETR_BATCH, h, h), generator=g, device=device)
        lo, hi = (v.float().contiguous() for v in torch.aminmax(x.reshape(-1, c), dim=0))
        copies = COPIES if x.numel() * x.element_size() < L2_BYTES else 1
        xs = [x] + [x.clone() for _ in range(copies - 1)]
        row = {"phase": "kernel_timing", "kernel": "spatial_quant",
               "cell": "rtdetr-l-serve-bs256", "scale": name, "shape": list(x.shape),
               "dtype": "torch.bfloat16", "mask": True, "bytes": quant_bytes(x, bits, mask),
               "ms": cuda_ms(lambda k: sq.spatial_quantize(xs[k], bits, lo, hi, mask),
                             reps=7, inner=copies, warmup=1, device_only=True),
               "plain_ms": cuda_ms(lambda k: sq.spatial_quantize_torch(xs[k], bits, lo, hi,
                                                                       mask),
                                   reps=3, inner=copies, warmup=1, device_only=True),
               "bound_ms": quant_bound_ms(x, bits, mask), "bound_by": "bytes"}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        emit(row)
        del x, xs, bits, mask
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 2b: the phi kernel against its plain version
# ---------------------------------------------------------------------------

PHI_OPTIONS = [(c, b, k) for c in ("cv2compat", "legacy") for b in ("adaptive", "otsu")
               for k in (True, False)]
# (B, ht, wt) of the synthetic maps per tile
PHI_SIZES = {1: (2, 5, 7), 2: (2, 5, 7), 4: (4, 10, 10), 8: (4, 6, 9), 16: (2, 4, 5),
             32: (2, 3, 4), 64: (2, 2, 3), 128: (1, 2, 2)}
PHI_CPU_ATOL = 1e-5        # against the CPU's plain version (its libm differs)
PHI_CPU_TILE_SHARE = 1e-3  # tiles allowed beyond PHI_CPU_ATOL, each traced


def phi_maps(device):
    """Phase 2b's gray maps, (name, tile, gray (B, ht*tile, wt*tile) float32
    normalized as `compute_phi_tiles` does): at every tile 1-128 a random
    map, and one whose first tile row is constant, first tile column zero
    and last tile a ramp with exactly tied gradients; the gray maps of a
    random YOLOv8n's P3 / P4 / P5 features at 640 px with downsample 1 and
    2 (tiles 8, 4, 4 and 4, 4, 4) and of its P5 at 64 and 32 px (tiles 2,
    1); letterboxed images as Eq.(8) scoring sees them at 128, 256, 640,
    1280 and 2048 px (tiles 16, 32, 64, 128, 256)."""
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.core import image_ops as iops
    from mcaq_yolo_tpu_torch.core import morphology as tm
    from mcaq_yolo_tpu_torch.data.dataset import letterbox
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.yolo import images_to_nchw

    maps = []
    for tile, (B, ht, wt) in PHI_SIZES.items():
        g = np.random.default_rng(100 + tile).random((B, ht * tile, wt * tile))
        maps.append(("random", tile, g.astype(np.float32)))
        g[:, :tile, :] = 0.375
        g[:, :, :tile] = 0.0
        y, x = np.mgrid[:tile, :tile]
        g[:, -tile:, -tile:] = ((x + y) % 8) / 8.0
        maps.append(("constant_zero_ties", tile, g.astype(np.float32)))
    maps = [(n, t, iops.normalize01(torch.from_numpy(g).to(device)).contiguous())
            for n, t, g in maps]

    model = MCAQYOLO(num_classes=80, dtype=torch.bfloat16, device=device, seed=0)
    images = serving_images(seed=12, count=1)
    with torch.inference_mode():
        for size, scales in ((IMG, (0, 1, 2)), (64, (2,)), (32, (2,))):
            x = torch.from_numpy(np.stack([letterbox(im, size)[0] for im in images[:4]]))
            feats = model.backbone(images_to_nchw(x.to(device), torch.bfloat16))
            for i in scales:
                f = feats[i].permute(0, 2, 3, 1)
                for ds in ((1, 2) if size == IMG else (1,)):
                    gray, tile = tm.prepare_gray(f, 8, ds)
                    maps.append((f"P{i + 3}_{size}px_ds{ds}", tile, gray.contiguous()))
        for size, n in ((128, 4), (256, 4), (IMG, 2), (1280, 1), (2048, 1)):
            x = torch.from_numpy(np.stack([letterbox(im, size)[0] for im in images[:n]]))
            gray, tile = tm.prepare_gray(x.to(device), 8, 1)
            maps.append((f"image_{size}px", tile, gray.contiguous()))
    return maps


def _phi_cpu_causes(gray, tile, canny_impl, binarize_impl, idx):
    """For the tiles `idx` whose phi on the card is beyond PHI_CPU_ATOL of
    the CPU's: how many have another edge map on the two devices (NMS: the
    direction bin from atan2, whose CPU and CUDA libm differ, or a tie), how
    many another Otsu bin in the kernel than in the plain version on either
    device (tiles above 128, `otsu_bins_differ`), how many only another
    mask, and how many none of these."""
    from mcaq_yolo_tpu_torch.core import morphology as tm
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml

    tiles = tm.extract_tiles(gray, tile)[0][idx]
    edge = tm.canny_legacy if canny_impl == "legacy" else tm.canny_cv2compat
    binz = tm.otsu_binarize if binarize_impl == "otsu" else tm.adaptive_binarize
    e = (edge(tiles).cpu() != edge(tiles.cpu())).flatten(1).any(1)
    o = (ml.otsu_bins_differ(tiles, canny_impl, binarize_impl).cpu()
         | ml.otsu_bins_differ(tiles.cpu(), canny_impl, binarize_impl)) & ~e
    m = (binz(tiles).cpu() != binz(tiles.cpu())).flatten(1).any(1) & ~e & ~o
    return {"edge_map": int(e.sum()), "otsu_rounding": int(o.sum()),
            "mask_only": int(m.sum()), "unexplained": int((~e & ~o & ~m).sum())}


def phase_phi_vs_plain(device) -> float:
    """The phi kernel against its plain version on the same maps, in every
    option: bitwise against the plain version on the card, but for a tile
    above 128 whose Otsu bin the plain version's rounded float sums moved
    (`otsu_bins_differ`: the 2048-px image's tiles of 256); against the
    plain version on the CPU, phi within PHI_CPU_ATOL on all but
    PHI_CPU_TILE_SHARE of the tiles, each such tile traced.  Returns the
    largest difference from the plain version on the card."""
    import torch

    from mcaq_yolo_tpu_torch.core import morphology as tm
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml

    worst, n_cases, n_tiles, far_tiles, otsu_tiles = 0.0, 0, 0, 0, 0
    causes = {"edge_map": 0, "otsu_rounding": 0, "mask_only": 0, "unexplained": 0}
    cuda_bitwise = cpu_bitwise = 0
    for name, tile, gray in phi_maps(device):
        cpu_gray = gray.cpu()
        for opt in PHI_OPTIONS:
            before = ml.phi_tiles.launches
            k = ml.phi_tiles(gray, tile, *opt)
            p = ml.phi_tiles_torch(gray, tile, *opt)
            torch.cuda.synchronize()
            check(ml.phi_tiles.launches == before + 1, "one phi_tiles call must count one launch")
            c = ml.phi_tiles_torch(cpu_gray, tile, *opt)
            kc = k.cpu()
            differ = (k.view(torch.int32) != p.view(torch.int32)).reshape(-1, 8).any(1)
            rounding = (ml.otsu_bins_differ(tm.extract_tiles(gray, tile)[0], *opt[:2])
                        if differ.any() else torch.zeros_like(differ))
            mism = int((differ & ~rounding).sum())
            err = float((k - p).abs().max())
            finite = bool(torch.isfinite(k).all())
            far = ((kc - c).abs() > PHI_CPU_ATOL).reshape(-1, 8).any(1)
            cpu_mism = int((kc.view(torch.int32) != c.view(torch.int32)).sum())
            row = {"phase": "phi_vs_plain", "kernel": "phi_tiles", "map": name, "tile": tile,
                   "shape": list(gray.shape), "options": list(opt), "tiles": far.numel(),
                   "cuda_mismatches": mism, "cuda_max_abs_err": err,
                   "cpu_mismatches": cpu_mism, "cpu_max_abs_err": float((kc - c).abs().max()),
                   "cpu_tiles_beyond_atol": int(far.sum()), "finite": finite,
                   "otsu_rounding_tiles": int((differ & rounding).sum())}
            if far.any():
                row["cpu_causes"] = _phi_cpu_causes(gray, tile, opt[0], opt[1],
                                                    far.nonzero()[:, 0].to(device))
                for key, v in row["cpu_causes"].items():
                    causes[key] += v
            emit(row)
            check(mism == 0 and finite, f"phi_tiles differs from its plain version on the "
                                        f"card: {name} tile {tile} {opt}: {mism} tiles")
            worst = max(worst, err)
            n_cases += 1
            n_tiles += far.numel()
            far_tiles += int(far.sum())
            otsu_tiles += row["otsu_rounding_tiles"]
            cuda_bitwise += not differ.any()
            cpu_bitwise += cpu_mism == 0
    share = far_tiles / n_tiles
    emit({"phase": "phi_vs_plain", "cases": n_cases, "tiles": n_tiles,
          "bitwise_vs_cuda_plain": f"{cuda_bitwise}/{n_cases}",
          "cuda_otsu_rounding_tiles": otsu_tiles,
          "bitwise_vs_cpu_plain": f"{cpu_bitwise}/{n_cases}",
          "cpu_tiles_beyond_atol": far_tiles, "cpu_share_beyond_atol": share,
          "cpu_causes": causes, "cpu_atol": PHI_CPU_ATOL, "cpu_tile_share": PHI_CPU_TILE_SHARE})
    check(share <= PHI_CPU_TILE_SHARE and causes["unexplained"] == 0,
          f"phi_tiles against the CPU's plain version: {far_tiles} of {n_tiles} tiles beyond "
          f"{PHI_CPU_ATOL}, causes {causes}")
    return worst


# ---------------------------------------------------------------------------
# Phase 2c
# ---------------------------------------------------------------------------


def phase_bn_silu(device, img: int = IMG) -> list:
    """The eval BatchNorm + SiLU kernel at every ConvBnSiLU shape of the
    forwards of BN_SILU_FORWARDS: held bitwise to F.batch_norm + F.silu on
    each distinct shape, then timed (module docstring, 2c).  One row a
    forward."""
    from collections import Counter

    import torch

    from mcaq_yolo_tpu_torch.ops import bn_silu as bs
    from mcaq_yolo_tpu_torch.utils.cuda_timing import (BN_SILU_OPS_PER_ELEMENT, COPIES,
                                                       L2_BYTES, bn_silu_bytes, bound_ms,
                                                       cuda_ms)

    def ordered(t):  # sign-magnitude bits -> integers in the floats' order
        i = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).long()
        return torch.where(i < 0, -(i & (2 ** (8 * t.element_size() - 1) - 1)), i)

    eps = 1e-3
    rows = []
    for variant, dtype_name, batch in BN_SILU_FORWARDS:
        dtype = getattr(torch, dtype_name)
        ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        shapes = Counter(conv_bn_silu_shapes(variant, batch, img))
        row = {"variant": variant, "dtype": dtype_name, "batch": batch,
               "modules": sum(shapes.values()), "distinct_shapes": len(shapes), "ms": 0.0,
               "library_ms": 0.0, "bytes": 0, "ops": 0, "max_abs_err": 0.0,
               "worst_ulps": 0, "library_max_abs_err": 0.0}
        for k, (shape, n) in enumerate(sorted(shapes.items())):
            C = shape[1]
            g = torch.Generator(device=device).manual_seed(k)
            x = (torch.randn(shape, generator=g, device=device) * 3.0).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            w = torch.rand(C, generator=g, device=device) + 0.5
            b = torch.randn(C, generator=g, device=device)
            m = torch.randn(C, generator=g, device=device)
            v = torch.rand(C, generator=g, device=device) * 2.0 + 0.05
            y = x.clone(memory_format=torch.channels_last)
            before = bs.launches()
            torch.ops.mcaq.bn_silu(y, w, b, m, v, eps)
            with torch.backends.cudnn.flags(enabled=False):  # ATen's channels-last kernel
                ref = bs.bn_silu_torch(x, w, b, m, v, eps)
            lib = bs.bn_silu_torch(x, w, b, m, v, eps)  # cuDNN's where it takes it
            torch.cuda.synchronize()
            check(bs.launches() == before + 1, f"bn_silu {shape}: no launch counted")
            row["max_abs_err"] = max(row["max_abs_err"],
                                     float((y.float() - ref.float()).abs().max()))
            row["library_max_abs_err"] = max(row["library_max_abs_err"],
                                             float((y.float() - lib.float()).abs().max()))
            row["worst_ulps"] = max(row["worst_ulps"], int((ordered(y) - ordered(ref)).abs().max()))
            check(torch.equal(y.view(ibits), ref.view(ibits)),
                  f"bn_silu {variant} {shape} {dtype_name}: not bitwise F.batch_norm + "
                  f"F.silu ({row['worst_ulps']} ulps apart)")
            del y, ref, lib
            # timed in place with BatchNorm's initial statistics (w = 1, b = 0,
            # mean 0, var 1), so the repeated SiLU keeps every value finite; a
            # map under the L2 cache's size is timed over COPIES distinct
            # copies in turn, so no launch finds its map in the cache
            copies = COPIES if x.numel() * x.element_size() < L2_BYTES else 1
            works = [x.clone(memory_format=torch.channels_last) for _ in range(copies)]
            one, zero = torch.ones_like(w), torch.zeros_like(w)
            ms = cuda_ms(lambda i: torch.ops.mcaq.bn_silu(works[i % copies], one, zero, zero,
                                                          one, eps),
                         reps=5, inner=max(copies, 5), warmup=1, device_only=True)
            library = cuda_ms(lambda i: bs.bn_silu_torch(works[i % copies], w, b, m, v, eps),
                              reps=5, inner=max(copies, 5), warmup=1, device_only=True)
            del works, x
            row["ms"] += n * ms
            row["library_ms"] += n * library
            numel = shape[0] * C * shape[2] * shape[3]
            row["bytes"] += n * bn_silu_bytes(numel, dtype.itemsize, C)
            row["ops"] += n * numel * BN_SILU_OPS_PER_ELEMENT
        torch.cuda.empty_cache()
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["library_share_of_bound"] = row["bound_ms"] / row["library_ms"]
        emit({"phase": "bn_silu", **row})
        rows.append(row)
    return rows


def bn_silu_kernel_entry(rows) -> dict:
    """The eval BatchNorm + SiLU kernel's entry of the `kernels` line: its
    device time a YOLOv8n bs-256 forward (phase 2c), that work's bound, the
    largest gap to F.batch_norm + F.silu that phase 2c measured on any
    forward, and its launches on every path (the deployed one as
    `launches`).  The plain version is the library's composition, so
    `plain_ms` is `library_ms`."""
    (n,) = [r for r in rows if r["variant"] == "yolov8n"]
    return {"name": "bn_silu", "route": "cuda", "source": BN_SILU_SOURCE, "replaces": None,
            "launches": BN_SILU_LAUNCHES.get("deployed"),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": n["ms"], "plain_ms": n["library_ms"], "bound_ms": n["bound_ms"],
            "bound_by": n["bound_by"], "library_ms": n["library_ms"],
            "launches_by_path": dict(BN_SILU_LAUNCHES)}


# ---------------------------------------------------------------------------
# Phase 2d
# ---------------------------------------------------------------------------


def phase_frac_quant(device, batch: int = FRAC_QUANT_BATCH) -> list:
    """The training quantize's kernel pair at the training cell's three maps
    in bfloat16 with the soft mask: held to the plain path, then timed
    (module docstring, 2d).  One row a map."""
    import torch

    from mcaq_yolo_tpu_torch.ops import frac_quant as fq
    from mcaq_yolo_tpu_torch.utils.cuda_timing import (COPIES, FRAC_QUANT_OPS_PER_ELEMENT,
                                                       L2_BYTES, bound_ms, cuda_ms,
                                                       frac_quant_bytes)

    def rel_l2(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    rows = []
    for k, (scale, H, C, Ht) in enumerate(FRAC_QUANT_MAPS):
        g = torch.Generator(device=device).manual_seed(k)
        x = (torch.randn(batch, H, H, C, generator=g, device=device) * 1.5).to(torch.bfloat16)
        bits = torch.rand(batch, Ht, Ht, generator=g, device=device) * 6.0 + 2.0
        lo, hi = (t.contiguous() for t in torch.aminmax(x.reshape(-1, C).float(), dim=0))
        mask = torch.rand(batch, H, H, 1, generator=g, device=device)
        up = torch.randn(x.shape, generator=g, device=device).to(torch.bfloat16)
        x.requires_grad_(True), bits.requires_grad_(True), mask.requires_grad_(True)

        def fwd_bwd(fn, xi, upi):
            out = fn(xi, bits, lo, hi, mask)
            return (out,) + torch.autograd.grad(out, (xi, bits, mask), upi)

        before = fq.launches()
        got, ref = fwd_bwd(fq.frac_quantize, x, up), fwd_bwd(fq.frac_quantize_torch, x, up)
        torch.cuda.synchronize()
        check(fq.launches() == before + 2, f"frac_quant {scale}: not 2 launches counted")
        gaps = {"grad_frac_rel_l2": rel_l2(got[2], ref[2]),
                "grad_mask_rel_l2": rel_l2(got[3], ref[3]),
                "max_abs_err": max(float((a.double() - b.double()).abs().max())
                                   for a, b in zip(got, ref))}
        check(torch.equal(got[0].view(torch.int16), ref[0].view(torch.int16))
              and torch.equal(got[1], ref[1])
              and max(gaps["grad_frac_rel_l2"], gaps["grad_mask_rel_l2"]) <= 1e-5,
              f"frac_quant {scale}: not the plain path ({gaps})")
        del got, ref
        # a map under the L2 cache's size is timed over COPIES distinct
        # copies in turn, so no launch finds its map in the cache
        copies = COPIES if x.numel() * x.element_size() < L2_BYTES else 1
        xs = [x.detach().clone().requires_grad_(True) for _ in range(copies)]
        ups = [up.clone() for _ in range(copies)]
        with torch.no_grad():
            fwd = cuda_ms(lambda i: fq.frac_quantize(xs[i % copies], bits, lo, hi, mask),
                          reps=5, inner=max(copies, 5), warmup=1, device_only=True)
        outs = [fq.frac_quantize(xi, bits, lo, hi, mask) for xi in xs]
        bwd = cuda_ms(lambda i: torch.autograd.grad(outs[i % copies], (xs[i % copies], bits, mask),
                                                    ups[i % copies], retain_graph=True),
                      reps=5, inner=max(copies, 5), warmup=1, device_only=True)
        del outs
        plain = cuda_ms(lambda i: fwd_bwd(fq.frac_quantize_torch, xs[i % copies], ups[i % copies]),
                        reps=5, inner=max(copies, 5), warmup=1, device_only=True)
        del xs, ups
        row = {"scale": scale, "shape": [batch, H, H, C], "tile": H // Ht, "fwd_ms": fwd,
               "bwd_ms": bwd, "ms": fwd + bwd, "plain_ms": plain, **gaps}
        for d, ms in (("fwd", fwd), ("bwd", bwd)):
            direction = "forward" if d == "fwd" else "backward"
            b, by = bound_ms(frac_quant_bytes(x, bits, direction),
                             x.numel() * FRAC_QUANT_OPS_PER_ELEMENT[direction])
            row[f"{d}_bound_ms"], row[f"{d}_bound_by"] = b, by
            row[f"{d}_share_of_bound"] = b / ms
        row["bound_ms"] = row["fwd_bound_ms"] + row["bwd_bound_ms"]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        torch.cuda.empty_cache()
        emit({"phase": "frac_quant", **row})
        rows.append(row)
    return rows


def frac_quant_kernel_entry(rows) -> dict:
    """The training quantize's entry of the `kernels` line: the forward and
    backward device time over the training cell's three maps (phase 2d),
    that work's bound, the plain path's forward + backward, the largest gap
    to the plain path phase 2d measured (output and the three gradients),
    and the launches each path counted (phase 5's training run's first)."""
    return {"name": "frac_quant", "route": "cuda", "source": FRAC_QUANT_SOURCE,
            "replaces": None, "launches": FRAC_QUANT_LAUNCHES.get("training"),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
            "library_ms": None, "launches_by_path": dict(FRAC_QUANT_LAUNCHES)}


# ---------------------------------------------------------------------------
# Phase 2e
# ---------------------------------------------------------------------------


def phase_conv_f32(device, batch: int = CONV_F32_BATCH, img: int = IMG) -> dict:
    """The float32 convolution kernel at the KD teacher's 35 shapes (YOLOv8m's
    77 ConvBnSiLU at bs 64 and 640 px): each shape's gap to float64 beside
    cuDNN float32's (TF32 off) and TF32's, then the device ms of the kernel,
    the plain version and cuDNN float32 summed over the 77, beside the
    bound at 165 TFLOP/s; then a whole teacher forward against a float64
    teacher (module docstring, 2e).  One row."""
    from collections import Counter

    import torch
    import torch.nn.functional as F

    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
    from mcaq_yolo_tpu_torch.ops import bn_silu as bs
    from mcaq_yolo_tpu_torch.ops import conv_f32 as cf
    from mcaq_yolo_tpu_torch.train import _teacher_outputs
    from mcaq_yolo_tpu_torch.utils.cuda_timing import cuda_ms

    def rel(a, ref):
        return float((a.double() - ref).norm() / ref.norm())

    def cudnn(x, w, s, p, tf32):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=tf32):
            return F.conv2d(x, w, None, s, p)

    convs = Counter((c[1], c[4], c[5], c[6], c[7], c[2])
                    for c in conv_bn_silu_convs("yolov8m", 1, img))
    row = {"batch": batch, "modules": sum(convs.values()), "distinct_shapes": len(convs),
           "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flop": 0, "shapes": []}
    for k, ((cin, cout, ks, s, p, size), n) in enumerate(sorted(convs.items())):
        g = torch.Generator(device=device).manual_seed(k)
        x = torch.randn(batch, cin, size, size, generator=g, device=device)
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randn(cout, cin, ks, ks, generator=g, device=device) / (cin * ks * ks) ** 0.5
        w = w.contiguous(memory_format=torch.channels_last)
        before = cf.launches()
        y = cf.conv_f32(x, w, (s, s), (p, p))
        check(cf.launches() == before + 1, f"conv_f32 {cin}->{cout} k{ks}: no launch counted")
        check(y.is_contiguous(memory_format=torch.channels_last),
              f"conv_f32 {cin}->{cout} k{ks}: the output is not channels-last")
        ref = F.conv2d(x.double(), w.double(), None, s, p)
        gaps = {"kernel": rel(y, ref), "library": rel(cudnn(x, w, s, p, False), ref),
                "tf32": rel(cudnn(x, w, s, p, True), ref)}
        del y, ref
        check(gaps["kernel"] <= 2 * gaps["library"] and gaps["tf32"] >= 100 * gaps["kernel"],
              f"conv_f32 {cin}->{cout} k{ks} s{s} at {size}: not float32-accurate {gaps}")
        ms = cuda_ms(lambda i: cf.conv_f32(x, w, (s, s), (p, p)), reps=3, inner=2, warmup=1,
                     device_only=True)
        plain = cuda_ms(lambda i: cf.conv_f32_torch(x, w, (s, s), (p, p)), reps=3, inner=1,
                        warmup=1, device_only=True)
        library = cuda_ms(lambda i: cudnn(x, w, s, p, False), reps=3, inner=2, warmup=1,
                          device_only=True)
        out = (size + 2 * p - ks) // s + 1
        flop = 2 * batch * out * out * cout * cin * ks * ks
        row["ms"] += n * ms
        row["plain_ms"] += n * plain
        row["library_ms"] += n * library
        row["flop"] += n * flop
        row["shapes"].append({"shape": [cin, cout, ks, s, p, size], "count": n, "ms": ms,
                              "plain_ms": plain, "library_ms": library,
                              "tflops": flop / ms / 1e9, "gap": gaps})
        del x, w
    torch.cuda.empty_cache()
    row["bound_ms"] = row["flop"] / CONV_F32_FLOPS * 1e3
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["worst_gap"] = {key: max(r["gap"][key] for r in row["shapes"])
                        for key in ("kernel", "library", "tf32")}
    row["worst_gap_ratio"] = max(r["gap"]["kernel"] / r["gap"]["library"]
                                 for r in row["shapes"])

    # a whole teacher forward (the train step's `_teacher_outputs`) against a
    # float64 teacher: the raw maps and C3/C4/C5; then the raw maps again
    # with the Detect head's six output biases zeroed, i.e. the convolutions'
    # own output
    teacher = YOLOv8("yolov8m", 80, device=device, seed=0)
    g = torch.Generator(device=device).manual_seed(5)
    images = torch.randint(0, 256, (batch, img, img, 3), generator=g, device=device,
                           dtype=torch.uint8)
    names = ("P3", "P4", "P5", "C3", "C4", "C5")

    def outputs(model):
        maps, feats = _teacher_outputs(model, images)
        return [t.double() for t in list(maps) + list(feats)]

    def gaps(timed: bool) -> dict:
        """Each output's gap to a float64 teacher's: by the kernel, by
        cuDNN float32 and by cuDNN TF32."""
        takes, bn_takes, tf32 = cf.takes, bs.takes, torch.backends.cudnn.allow_tf32
        try:
            torch.backends.cudnn.allow_tf32 = False
            before = cf.launches()
            got = outputs(teacher)
            if timed:
                CONV_F32_LAUNCHES["teacher_yolov8m"] = cf.launches() - before
                check(CONV_F32_LAUNCHES["teacher_yolov8m"] == row["modules"],
                      f"a teacher forward launched conv_f32 {cf.launches() - before} times")
                row["teacher_ms"] = cuda_ms(lambda i: _teacher_outputs(teacher, images),
                                            reps=3, warmup=1)
            cf.takes = lambda x, conv: False
            lib = outputs(teacher)
            if timed:
                row["teacher_library_ms"] = cuda_ms(
                    lambda i: _teacher_outputs(teacher, images), reps=3, warmup=1)
            torch.backends.cudnn.allow_tf32 = True
            tf = outputs(teacher)
            torch.backends.cudnn.allow_tf32 = False
            bs.takes = lambda x, bn: False  # no float64 in the bn_silu kernel
            t64 = copy.deepcopy(teacher).double()
            t64.dtype = torch.float64
            ref = outputs(t64)
            del t64
        finally:
            cf.takes, bs.takes, torch.backends.cudnn.allow_tf32 = takes, bn_takes, tf32
        out = {key: dict(zip(names, (rel(a, r) for a, r in zip(outs, ref))))
               for key, outs in (("kernel", got), ("library", lib), ("tf32", tf))}
        del got, lib, tf, ref
        torch.cuda.empty_cache()
        return out

    row["teacher_gap"] = gap = gaps(timed=True)
    with torch.no_grad():
        for m in teacher.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.zero_()
    row["teacher_gap_unbiased"] = unbiased = {
        key: {n: v[n] for n in names[:3]} for key, v in gaps(timed=False).items()}
    del teacher, images
    torch.cuda.empty_cache()
    # the raw maps of a seeded teacher are mostly the Detect head's biases:
    # their gap is float32's rounding of the output, held to the 2x alone;
    # without the biases they are held as C3/C4/C5 are
    check(all(gap["kernel"][n] <= 2 * gap["library"][n] for n in names)
          and all(gap["tf32"][n] >= 100 * gap["kernel"][n] for n in names[3:])
          and all(unbiased["kernel"][n] <= 2 * unbiased["library"][n]
                  and unbiased["tf32"][n] >= 100 * unbiased["kernel"][n] for n in names[:3]),
          f"conv_f32: a teacher forward is not float32-accurate {gap} {unbiased}")
    emit({"phase": "conv_f32", **{k: v for k, v in row.items() if k != "shapes"}})
    for r in row["shapes"]:
        emit({"phase": "conv_f32_shape", **r})
    return row


def conv_f32_kernel_entry(row) -> dict:
    """The float32 convolution kernel's entry of the `kernels` line: its
    device time over the KD teacher's 77 convolutions at bs 64 (phase 2e),
    that work's bound at 165 TFLOP/s, the plain version's and cuDNN
    float32's time, its worst gap to float64 over the 35 shapes, and the
    launches each path counted (phase 5's training run's first)."""
    return {"name": "conv_f32", "route": "triton", "source": CONV_F32_SOURCE,
            "replaces": None, "launches": CONV_F32_LAUNCHES.get("training"),
            "max_rel_l2_to_float64": row["worst_gap"]["kernel"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": "ops",
            "library_ms": row["library_ms"], "launches_by_path": dict(CONV_F32_LAUNCHES)}


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
    """Random MCAQ-YOLOv8n (nc=80) from `seed`, spread over bit widths and
    detections by `spread_model`."""
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    model = MCAQYOLO(variant="yolov8n", num_classes=80, bit_mapping="mlp",
                     monotone_param="softplus", morph_downsample=2, dtype=dtype,
                     device=device, seed=seed)
    return spread_model(model, device, dtype, seed)


def spread_model(model, device, dtype, seed: int = 0):
    """The bit mapper's BatchNorm statistics taken from the model's own
    complexity maps on seeded images and its output layer steepened, so that
    an untrained mapper spreads tiles over several bit widths (a random
    monotone MLP is nearly flat over the complexity range it sees); each
    class output scaled and biased so a few anchors per image clear conf
    0.25.  In place; returns the model."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mcaq_yolo_tpu_torch.data.dataset import letterbox
    from mcaq_yolo_tpu_torch.models.yolo import images_to_nchw

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

    zero_launches()
    t0 = time.perf_counter()
    results = pred.predict_batch(images, batch_size=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sq.spatial_quantize.launches
    forwards = 3
    # one phi launch per scale per forward, one bn_silu per ConvBnSiLU (and
    # one conv_f32 per ConvBnSiLU of a float32 network)
    phi = phi_launches("deployed", 3 * forwards,
                       bn=conv_bn_silu_modules(pred.model) * forwards,
                       cf=conv_bn_silu_modules(pred.model) * forwards
                       if dtype == torch.float32 else 0)
    bn = BN_SILU_LAUNCHES["deployed"]

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
          "launches": {"spatial_quant": launches, "phi_tiles": phi, "bn_silu": bn},
          "avg_bits": [round(r["avg_bits"], 4) for r in results[::8]],
          "bit_widths_seen": sorted(float(b) for b in np.unique(bits)),
          "detections": sum(len(r["detections"]) for r in results),
          "pool_saturations": pred.pool_saturations})

    backend_parity(pred, images[:8], device, "backend_parity")
    return pred, launches


def phase_family_deployed(device, dtype, workdir: Path, variant: str) -> int:
    """A seeded MCAQ `variant` of FAMILY_CALLS (nc 80, the serving cells' MCAQ
    settings) written as a checkpoint + meta and served by `Predictor` at
    640 px in `dtype` (conf 0.25, IoU 0.45, max_det 300; RT-DETR NMS-free)
    over one batch of 8 letterboxed images: 3 spatial_quant and 3 phi_tiles
    launches in the call, bn_silu once a SiLU ConvBn and the counter
    `area_attention` as FAMILY_CALLS says, finite detections; then its raw
    maps bitwise equal through the kernel and through its plain version.
    Returns the call's spatial_quant launches."""
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.inference import Predictor
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
    from mcaq_yolo_tpu_torch.models.yolo import family
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.utils import profiling
    from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint

    path, want_bn, want_attn = FAMILY_CALLS[variant]
    fam = family(variant)
    model = MCAQYOLO(variant=variant, num_classes=80, bit_mapping="mlp",
                     monotone_param="softplus", morph_downsample=2, dtype=dtype,
                     device=device, seed=0)
    ckpt = workdir / f"mcaq_{variant.replace('-', '_')}.ckpt"
    save_checkpoint(ckpt, to_jax_variables(model), {
        "epoch": 0, "variant": variant, "num_classes": 80, "img_size": IMG,
        "deploy_temperature": 1.0,
        "config": {"quantization": {"min_bits": 2, "max_bits": 8, "target_bits": 4.0,
                                    "grid_size": 8, "bit_mapping": "mlp",
                                    "monotone_param": "softplus",
                                    "normalize_complexity": False},
                   "morphology": {"downsample": 2, "tile_engine": "lanes"}}})
    del model
    pred = Predictor(str(ckpt), conf_threshold=0.25, max_det=300, dtype=dtype, device=device)
    check(pred.model.family == fam and pred.model.head.nms_pool == (fam != "rtdetr"),
          f"the {variant} checkpoint was not served as {fam}")
    images = serving_images(seed=3, count=1)

    attn0 = profiling.counters().get("area_attention", 0)
    zero_launches()
    t0 = time.perf_counter()
    results = pred.predict_batch(images, batch_size=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sq.spatial_quantize.launches
    attn = profiling.counters().get("area_attention", 0) - attn0
    modules = conv_bn_silu_modules(pred.model)
    check(modules == want_bn, f"{variant} has {modules} SiLU ConvBns (expected {want_bn})")
    phi = phi_launches(path, 3, bn=modules)
    check(launches == 3, f"spatial_quant launched {launches} times in one {variant} call "
                         "(expected 3)")
    check(attn == want_attn, f"{variant}: {attn} area attentions in one call "
                             f"(expected {want_attn})")
    check(len(results) == len(images), "predict_batch dropped images")
    for r in results:
        check(2.0 <= r["avg_bits"] <= 8.0, f"avg_bits {r['avg_bits']} outside [2, 8]")
        for det in r["detections"]:
            check(np.isfinite(det["bbox"]).all() and np.isfinite(det["confidence"]),
                  "non-finite detection")
    emit({"phase": path, "variant": variant, "images": len(images),
          "batches": 1, "img_size": IMG, "dtype": str(dtype), "wall_s": round(wall, 3),
          "launches": {"spatial_quant": launches, "phi_tiles": phi,
                       "bn_silu": BN_SILU_LAUNCHES[path]},
          "area_attention": attn,
          "detections": sum(len(r["detections"]) for r in results)})
    backend_parity(pred, images, device, f"{fam}_backend_parity")
    del pred
    torch.cuda.empty_cache()
    return launches


def backend_parity(pred, images, device, phase: str) -> int:
    """One forward through the kernel and one through its plain version on
    the same letterboxed images: the raw maps must be bitwise equal."""
    import numpy as np
    import torch

    x = torch.from_numpy(np.stack([pred.preprocess(im)[0] for im in images])).to(device)
    return model_parity(pred.model, x, phase)


def model_parity(model, x, phase: str) -> int:
    """`model`'s eval forward on x with quant_backend 'auto' (the kernel) and
    'torch' (its plain version): raw maps bitwise equal, 3 launches in the
    kernel's forward, none in the plain one.  Both forwards run the model's
    phi engine ('lanes': the phi kernel, 3 launches each).  Returns the
    kernel's launches."""
    import torch

    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq

    with torch.inference_mode():
        before, phi0 = sq.spatial_quantize.launches, ml.phi_tiles.launches
        raw_k, _ = model(x)
        torch.cuda.synchronize()
        launches = sq.spatial_quantize.launches - before
        phi_k = ml.phi_tiles.launches - phi0
        model.set_quant_backend("torch")
        raw_p, _ = model(x)
        model.set_quant_backend("auto")
        plain_launches = sq.spatial_quantize.launches - before - launches
        phi_p = ml.phi_tiles.launches - phi0 - phi_k
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(raw_k, raw_p))
    finite = all(bool(torch.isfinite(a).all()) for a in raw_k)
    emit({"phase": phase, "raw_maps_bitwise_equal": same, "finite": finite,
          "batch": int(x.shape[0]), "shapes": [list(a.shape) for a in raw_k],
          "launches": {"kernel_forward": launches, "plain_forward": plain_launches,
                       "phi_kernel_forward": phi_k, "phi_plain_forward": phi_p}})
    check(same and finite, f"{phase}: raw maps differ between quant_backend 'auto' and "
                           "'torch'")
    check(launches == 3 and plain_launches == 0,
          f"{phase}: {launches} launches through the kernel, {plain_launches} through the "
          "plain version (expected 3 and 0)")
    check(phi_k == phi_p == 3 * (model.complexity_analyzer.tile_engine == "lanes"),
          f"{phase}: phi launches {phi_k} and {phi_p} in the two forwards (expected the "
          "same engine in both, 3 each)")
    return launches


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

    for bs in (32, 256):
        xb = x32 if bs == 32 else torch.from_numpy(
            rng.integers(0, 256, (bs, IMG, IMG, 3), dtype=np.uint8)).to(device)
        nms_keep_parity(pred, xb)
        del xb

    return rows, phi_timings(model, x32, rng, device, dtype)


def phi_timings(model, x32, rng, device, dtype):
    """The phi kernel at each scale of the deployed model (downsample 2: tile
    4 on 40 x 40, 40 x 40 and 20 x 20 gray maps) at bs 32 and 256 (cell
    'serving'), at P3 with downsample 1 (tile 8 on 80 x 80, bs 32, 'p3_ds1')
    and on Eq.(8) scoring's maps of 8 letterboxed images ('scoring': tile 64
    at 640 px, 128 at 1280 px, 256 at 2048 px): the device time of the
    kernel (8 launches back to back) and of its plain version (one call),
    queued behind a device sleep, median of 21, and the bound; at bs 32, the CUDA kernels of one
    serving scale's phi (gray preparation included) with each engine,
    counted from CUDA graph captures."""
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.core import morphology as tm
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.data.dataset import letterbox
    from mcaq_yolo_tpu_torch.models.yolo import images_to_nchw
    from mcaq_yolo_tpu_torch.utils import profiling
    from mcaq_yolo_tpu_torch.utils.cuda_timing import bound_ms, cuda_ms

    def timed_row(cell, name, bs, gray, tile):
        n_bytes, n_ops = ml.phi_tiles_bytes(gray, tile), ml.phi_tiles_ops(gray.numel())
        row = {"phase": "phi_timing", "kernel": "phi_tiles", "cell": cell, "scale": name,
               "batch": bs, "gray": list(gray.shape), "tile": tile, "bytes": n_bytes,
               "ops": n_ops,
               "ms": cuda_ms(lambda k: ml.phi_tiles(gray, tile), inner=8, device_only=True),
               "plain_ms": cuda_ms(lambda k: ml.phi_tiles_torch(gray, tile), device_only=True),
               "ms_host_paced": cuda_ms(lambda k: ml.phi_tiles(gray, tile), inner=8),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        return row

    rows = []
    grid, ds = model.grid_size, model.morph_downsample
    for bs in (32, 256):
        xb = x32 if bs == 32 else torch.from_numpy(
            rng.integers(0, 256, (bs, IMG, IMG, 3), dtype=np.uint8)).to(device)
        with torch.inference_mode():
            feats = model.backbone(images_to_nchw(xb, dtype))
            for (name, *_), f in zip(SCALES, feats):
                xf = f.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
                gray, tile = tm.prepare_gray(xf, grid, ds)
                row = timed_row("serving", name, bs, gray, tile)
                if bs == 32:
                    n0 = ml.phi_tiles.launches
                    row["cuda_kernels"] = {
                        "phi_lanes": profiling.cuda_kernels(
                            lambda t: tm.compute_phi_tiles(t, grid_size=grid, downsample=ds)[0],
                            xf),
                        "phi_rows": profiling.cuda_kernels(
                            lambda t: tm.compute_phi_tiles(t, grid_size=grid, downsample=ds,
                                                           tile_engine="rows")[0], xf)}
                    # cuda_kernels calls its function 3 times: the lanes phi
                    # launches the kernel once each, the rows phi never
                    row["phi_launches_in_counts"] = ml.phi_tiles.launches - n0
                    check(row["cuda_kernels"]["phi_lanes"] <= 16
                          and row["phi_launches_in_counts"] == 3,
                          f"phi at {name}: {row['cuda_kernels']} kernels, "
                          f"{row['phi_launches_in_counts']} phi launches (expected <= 16 "
                          "kernels, one of them the phi kernel)")
                rows.append(row)
                emit(row)
            if bs == 32:
                xf = feats[0].contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
                gray, tile = tm.prepare_gray(xf, grid, 1)
                rows.append(timed_row("p3_ds1", "P3", bs, gray, tile))
                emit(rows[-1])
        del xb, feats
    images = serving_images(seed=21, count=1)
    for size in (IMG, 1280, 2048):
        x = torch.from_numpy(np.stack([letterbox(im, size)[0] for im in images]))
        gray, tile = tm.prepare_gray(x.to(device), 8, 1)
        rows.append(timed_row("scoring", f"image_{size}px", len(images), gray.contiguous(),
                              tile))
        emit(rows[-1])
    return rows


def nms_keep_parity(pred, xb):
    """Decode + NMS alone on the served program's raw maps of batch xb, once
    with the eager keep loop (`nms.keep_fixed_point`, what eager callers run)
    and once with the `while_loop` one that torch.export traces, called
    eagerly in its place: the keep results bitwise equal."""
    import torch

    from mcaq_yolo_tpu_torch.models.yolo import decode_and_nms
    from mcaq_yolo_tpu_torch.ops import nms

    with torch.inference_mode():
        raw, _ = pred.model(xb, temperature=pred.deploy_temperature, quantize=True)
        eager_loop, outs = nms.keep_fixed_point, {}
        for name, loop in (("python_loop", eager_loop),
                           ("while_loop", nms.keep_fixed_point_traced)):
            nms.keep_fixed_point = loop
            try:
                outs[name] = decode_and_nms(
                    raw, pred.num_classes, conf_threshold=pred.conf_threshold,
                    iou_threshold=pred.iou_threshold, max_det=pred.max_det,
                    pre_topk=pred.pre_topk)
            finally:
                nms.keep_fixed_point = eager_loop
    same = all(torch.equal(a, b) for a, b in zip(outs["python_loop"], outs["while_loop"]))
    emit({"phase": "nms_keep_parity", "batch": int(xb.shape[0]), "bitwise_equal": same,
          "detections": int(outs["python_loop"][3].sum())})
    check(same, "the while_loop keep differs from the eager loop's")


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

    zero_launches()
    t0 = time.perf_counter()
    epochs = [trainer.train_epoch(e) for e in range(3)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = sq.spatial_quantize.launches
    # 3 one-batch epochs, 3 scales; the float32 KD teacher's eval forward a
    # step (its BatchNorm + SiLU and its convolutions; the bf16 student's
    # run neither); the 2 Stage-3 steps' training quantize, forward and
    # backward
    teacher_modules = conv_bn_silu_modules(trainer.teacher)
    train_phi = phi_launches("training", 3 * 3, bn=3 * teacher_modules, fq=2 * 3 * 2,
                             cf=3 * teacher_modules)
    grads = _grad_groups(trainer.model)
    grad_norms = {k: float(v.norm()) for k, v in grads.items()}
    num_batches = [int(q.num_batches) for q in trainer.model.quantizers]
    emit({"phase": "training", "img_size": img, "batch": batch, "num_classes": 80,
          "dtype": "bfloat16 convolutions, float32 weights" if trainer.amp_dtype else "float32",
          "teacher": "float32", "wall_s": round(train_s, 3),
          "epochs": [{k: (round(v, 6) if isinstance(v, float) else v) for k, v in e.items()}
                     for e in epochs],
          "grad_norms_last_step": grad_norms, "quantizer_num_batches": num_batches,
          "launches": {"spatial_quant": train_launches, "phi_tiles": train_phi}})
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
    zero_launches()
    calibrate(trainer.model, calib, num_images=2 * batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    calib_launches = sq.spatial_quantize.launches
    # the trained model's float32 weights, no autocast: its convolutions too
    calib_phi = phi_launches("calibration", 3 * 2, bn=2 * conv_bn_silu_modules(trainer.model),
                             cf=2 * conv_bn_silu_modules(trainer.model))
    stats = [(int(q.num_batches), bool(q.frozen)) for q in trainer.model.quantizers]
    emit({"phase": "calibration", "batches": 2, "quantizer_state": stats,
          "launches": {"spatial_quant": calib_launches, "phi_tiles": calib_phi}})
    check(stats == [(4, True)] * 3, f"calibration state {stats}")
    check(calib_launches == 3 * 2, f"spatial_quant launched {calib_launches} times in "
                                   "2 calibration forwards (expected 3 each)")

    path = trainer.save_checkpoint("trained.ckpt", 2)
    pred = Predictor(str(path), conf_threshold=0.25, iou_threshold=0.45, max_det=300,
                     dtype=torch.bfloat16, device=device)
    check(all(bool(q.frozen) for q in pred.model.quantizers), "frozen stats not served")
    images = serving_images(seed=5, count=1)
    zero_launches()
    results = pred.predict_batch(images, batch_size=8)
    if device.type == "cuda":
        torch.cuda.synchronize()
    serve_launches = sq.spatial_quantize.launches
    serve_phi = phi_launches("trained_serving", 3, bn=conv_bn_silu_modules(pred.model))
    emit({"phase": "trained_serving", "images": len(results), "batch_size": 8,
          "avg_bits": round(results[0]["avg_bits"], 4),
          "detections": sum(len(r["detections"]) for r in results),
          "launches": {"spatial_quant": serve_launches, "phi_tiles": serve_phi}})
    for r in results:
        check(2.0 <= r["avg_bits"] <= 8.0 and np.isfinite(r["complexity_map"]).all(),
              "trained model served a bad result")
        for d in r["detections"]:
            check(np.isfinite(d["bbox"]).all(), "non-finite detection")
    check(serve_launches == 3, f"spatial_quant launched {serve_launches} times in one "
                               "forward of the trained model (expected 3)")
    backend_parity(pred, images, device, "trained_backend_parity")
    return {"training": train_launches, "calibration": calib_launches,
            "trained_serving": serve_launches}


def phase_step_cuda_vs_cpu(device, img: int = 128, batch: int = 2):
    """One float32 train step (Stage 3, KD) at `img` px on the card and on
    the CPU from the same seeded weights and batch, TF32 off: loss terms
    within 1e-3 relative, each group's gradient within 1e-2 relative L2."""
    import torch

    from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
    from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
    from mcaq_yolo_tpu_torch.ops import conv_f32, frac_quant
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
        f0, c0 = frac_quant.launches(), conv_f32.launches()
        m = step(opt, {k: torch.from_numpy(v).to(dev) for k, v in data.items()}, 1.0, 4.0,
                 0.05, 0.1, 0.5, 1e-4, quantize=True, use_kd=True)
        launched, convs = frac_quant.launches() - f0, conv_f32.launches() - c0
        # the kernels on the card only: a forward and a backward a quantizer;
        # the float32 teacher's convolutions (the student's need gradients)
        check(launched == (6 if dev.type == "cuda" else 0),
              f"step on {dev.type}: the frac_quant kernels launched {launched} times")
        want = conv_bn_silu_modules(teacher) if dev.type == "cuda" else 0
        check(convs == want,
              f"step on {dev.type}: the conv_f32 kernel launched {convs} times (expected {want})")
        if dev.type == "cuda":
            FRAC_QUANT_LAUNCHES["step_cuda_vs_cpu"] = launched
            CONV_F32_LAUNCHES["step_cuda_vs_cpu"] = convs
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


# ---------------------------------------------------------------------------
# Phase 6
# ---------------------------------------------------------------------------

DISK_TRAIN, DISK_VAL, DISK_EPOCHS = 128, 32, 5


def _device_busy_ms(prof) -> tuple:
    """(union of the CUDA kernel intervals in ms, kernel event count) of a
    torch.profiler run."""
    import torch

    kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for ev in sorted(kernels, key=lambda ev: ev.time_range.start):
        s_, e_ = ev.time_range.start, ev.time_range.end
        busy_us += max(0.0, e_ - max(s_, end))
        end = max(end, e_)
    return busy_us / 1e3, len(kernels)


def _images_per_s(loader, device, n_batches: int) -> float:
    """Batches per second of a loader alone (no model), in images/s."""
    import torch

    t0, n = time.perf_counter(), 0
    for i, batch in enumerate(loader):
        img = torch.as_tensor(batch["image"]).to(device)
        n += img.shape[0]
        if i + 1 >= n_batches:
            break
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def _differing_state(a, b) -> list:
    """Names of the model tensors, AdamW moments and counts that differ
    bitwise between two trainers."""
    import torch

    bad = [n for (n, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items())
           if not torch.equal(x, y)]
    for i, (p, q) in enumerate(zip(a.optimizer.params, b.optimizer.params)):
        sa, sb = a.optimizer.opt.state[p], b.optimizer.opt.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            if not torch.equal(sa[k].float(), sb[k].float().to(sa[k].device)):
                bad.append(f"adamw[{i}].{k}")
    if a.optimizer.step_count != b.optimizer.step_count:
        bad.append("step_count")
    return bad


def _evaluate_split(trainer, epoch: int, gpu: str) -> None:
    """Where `Trainer.evaluate`'s time goes: the val loader, the eval forward
    + decode + NMS on the card (with the copy of the detections to the host)
    and the host's mAP matching, each timed alone on the host clock, beside
    one whole `evaluate` call."""
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.train import Trainer
    from mcaq_yolo_tpu_torch.utils.evaluation import (
        compute_map, compute_map50_95, detections_to_numpy, extract_targets_per_image)

    temp = trainer.curriculum.get_effective_temperature(epoch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = Trainer.evaluate(trainer, epoch)  # unwrapped: not counted as a path's launches
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = list(trainer.val_loader)
    load_s = time.perf_counter() - t0
    predictions, targets = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        images = torch.as_tensor(batch["image"]).to(trainer.device)
        b, s, c, v, _ = trainer.eval_step(images, temp, quantize=True)
        predictions.extend(detections_to_numpy(b, s, c, v))  # copies to the host: synchronises
        targets.extend(extract_targets_per_image(batch))
    forward_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = (compute_map(predictions, targets, 0.5)["map"],
             compute_map50_95(predictions, targets)["map50_95"])
    match_s = time.perf_counter() - t0
    emit({"phase": "evaluate_split", "gpu": gpu, "epoch": epoch,
          "images": len(targets), "detections": int(sum(len(p["scores"]) for p in predictions)),
          "evaluate_s": whole_s, "val_loader_s": load_s, "forward_nms_s": forward_s,
          "map_matching_s": match_s, "timing": "host clock, each part alone"})
    check(np.allclose(split, (whole["map50"], whole["map50_95"]), rtol=0, atol=1e-6),
          f"evaluate's split disagrees with evaluate: {split} vs {whole}")


def phase_train_from_disk(device, workdir: Path, gpu: str, img: int = IMG,
                          batch: int = TRAIN_BATCH):
    """Train from a YOLO-format dataset on disk through `Trainer(config).train()`:
    loaders, Eq.(8) scoring, tau_t subsets, the Stage-2 refit, validation
    loss, mAP `evaluate` (through the kernel from Stage 2 on), best / last
    checkpoints, resume, serving of best.ckpt, and one epoch through the
    device-resident pipeline."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.data.dataset import DataLoader, YOLODataset, make_synthetic_dataset_v3
    from mcaq_yolo_tpu_torch.data.device_pipeline import augment_batch
    from mcaq_yolo_tpu_torch.inference import Predictor
    from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.train import Trainer
    from mcaq_yolo_tpu_torch.utils.checkpoint import write_msgpack

    t0 = time.perf_counter()
    make_synthetic_dataset_v3(str(workdir / "ds"), n_images=DISK_TRAIN, img_size=img,
                              n_val=DISK_VAL, seed=7)
    write_s = time.perf_counter() - t0
    tpath = workdir / "disk_teacher.msgpack"
    tpath.write_bytes(write_msgpack(to_jax_variables(YOLOv8("yolov8n", 80, device="cpu",
                                                            seed=1))))
    out = workdir / "disk"
    config = {
        "epochs": DISK_EPOCHS, "batch_size": batch, "learning_rate": 1e-3, "seed": 0,
        "output_dir": str(out),
        "model": {"name": "yolov8n", "num_classes": 80, "teacher_path": str(tpath)},
        "data": {"train": str(workdir / "ds" / "images" / "train"),
                 "val": str(workdir / "ds" / "images" / "val"),
                 "img_size": img, "max_boxes": 128, "num_workers": 2},
        "morphology": {"downsample": 2},
        "quantization": {"bit_mapping": "mlp", "monotone_param": "softplus"},
        # epochs 0-1: Stage 1 (epoch 0 on the tau_t subset), 2: Stage 2, 3-4: Stage 3
        "curriculum": {"warmup_epochs": 1, "transition_epochs": 2},
        "scheduler": {"warmup_epochs": 1}, "distillation": {"enabled": True},
        "training": {"amp": True, "map_interval": 1},
    }
    t0 = time.perf_counter()
    trainer = Trainer(config, device=device)
    init_s = time.perf_counter() - t0
    check(trainer.amp_dtype == torch.bfloat16, "amp not bf16")
    check((out / "complexity_scores.npy").exists()
          and (out / "complexity_scores.npy.meta.json").exists(), "scores cache not written")
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    rescored = trainer._compute_complexity_scores(use_cache=False)
    score_s = time.perf_counter() - t0
    # compute_dataset_complexity's batches of 8, one launch (64 x 64 tiles) each
    phi_launches("eq8_scoring", -(-DISK_TRAIN // 8), bn=0)
    check(np.array_equal(rescored, trainer.complexity_scores), "Eq.(8) scores not deterministic")
    fw0 = trainer.model.complexity_analyzer.feature_weights.clone()

    # kernel launches per path, against the eval forwards that ran them
    counts = {"evaluate": [0, 0, 0], "val_loss": [0, 0, 0]}
    forwards = [0, 0]  # quantized eval forwards, all eval forwards
    # the float32 student's eval forwards, quantized or not (MCAQYOLO runs
    # an eval forward without autograd, so its convolutions take conv_f32)
    eval_forwards = {"evaluate": 0, "val_loss": 0}

    def count_forward(module, args, kwargs):
        forwards[1] += not kwargs.get("training", False)
        if kwargs.get("quantize", True) and not kwargs.get("training", False):
            forwards[0] += 1

    def counted(name, fn):
        def run(epoch):
            l0, f0, p0 = sq.spatial_quantize.launches, forwards[0], ml.phi_tiles.launches
            a0 = forwards[1]
            r = fn(epoch)
            torch.cuda.synchronize()
            counts[name][0] += sq.spatial_quantize.launches - l0
            counts[name][1] += forwards[0] - f0
            counts[name][2] += ml.phi_tiles.launches - p0
            eval_forwards[name] += forwards[1] - a0
            return r
        return run

    trainer.evaluate = counted("evaluate", trainer.evaluate)
    trainer.compute_val_loss = counted("val_loss", trainer.compute_val_loss)
    hook = trainer.model.register_forward_pre_hook(count_forward, with_kwargs=True)
    zero_launches()
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = sq.spatial_quantize.launches
    # the training quantize: a forward and a backward of the 3 quantizers
    # in every step from Stage 2 on; the float32 convolutions of the KD
    # teacher's forward in every step and of the float32 student's eval
    # forwards (evaluate, validation loss)
    phi_launches("train_from_disk", fq=6 * sum(h["batches"] for h in trainer.history
                                                if h["stage"] >= 2),
                 cf=conv_bn_silu_modules(trainer.teacher) * sum(h["batches"]
                                                                 for h in trainer.history)
                 + conv_bn_silu_modules(trainer.model) * sum(eval_forwards.values()))
    for name, (_, _, n_phi) in counts.items():
        PHI_LAUNCHES[name] = n_phi
        check(n_phi > 0, f"{name}: the phi kernel never launched")
    hook.remove()
    hist = trainer.history
    emit({"phase": "train_from_disk", "gpu": gpu, "images": [DISK_TRAIN, DISK_VAL],
          "img_size": img, "batch": batch, "epochs": DISK_EPOCHS,
          "dataset_write_s": write_s, "trainer_init_s": init_s, "scoring_s": score_s,
          "scoring_images_per_s": DISK_TRAIN / score_s, "train_call_s": train_s,
          "result": result,
          "epochs_detail": [{k: h.get(k) for k in (
              "epoch", "stage", "subset_size", "batches", "loss_total", "loss_det", "val_loss",
              "map50", "map50_95", "avg_bits", "epoch_s", "train_s", "eval_s")} for h in hist],
          "train_images_per_s": [h["batches"] * batch / h["train_s"] for h in hist],
          "evaluate_images_per_s": [DISK_VAL / h["eval_s"] for h in hist],
          "feature_weights": [round(float(v), 6) for v in
                              trainer.model.complexity_analyzer.feature_weights],
          "launches": {"spatial_quant": launches, **{k: v[0] for k, v in counts.items()},
                       "phi_tiles": PHI_LAUNCHES["train_from_disk"],
                       **{f"phi_{k}": v[2] for k, v in counts.items()}},
          "quantized_eval_forwards": {k: v[1] for k, v in counts.items()},
          "eval_forwards": eval_forwards})
    check([h["stage"] for h in hist] == [1, 1, 2, 3, 3], "stages are not 1, 1, 2, 3, 3")
    check(hist[0]["subset_size"] is not None and hist[0]["subset_size"] < DISK_TRAIN,
          f"the Stage-1 tau_t subset did not filter: {hist[0]['subset_size']}")
    fw = trainer.model.complexity_analyzer.feature_weights
    check(not torch.equal(fw, fw0) and bool((fw >= 0).all())
          and abs(float(fw.sum()) - 1.0) < 1e-5, f"no Stage-2 refit onto the simplex: {fw}")
    for h in hist:
        check(all(np.isfinite(h[k]) for k in LOSS_KEYS) and np.isfinite(h["val_loss"]),
              f"non-finite loss in epoch {h['epoch']}")
        if h["stage"] >= 2:
            check(np.isfinite(h["map50"]) and np.isfinite(h["map50_95"])
                  and 2.0 <= h["avg_bits"] <= 8.0, f"bad evaluate in epoch {h['epoch']}: {h}")
    for name, (n_launch, n_fwd, _) in counts.items():
        check(n_fwd > 0 and n_launch == 3 * n_fwd,
              f"{name}: {n_launch} spatial_quant launches in {n_fwd} quantized forwards")
    check(launches == sum(v[0] for v in counts.values()), "a launch outside evaluate/val loss")
    for name in ("best.ckpt", "last.ckpt", "history.json"):
        check((out / name).exists(), f"{name} not written")
    _evaluate_split(trainer, DISK_EPOCHS - 1, gpu)

    # resume: a fresh trainer from last.ckpt holds the same state, bitwise
    resumed = Trainer(config, device=device)
    resumed.load_checkpoint(out / "last.ckpt")
    diff = _differing_state(trainer, resumed)
    emit({"phase": "resume", "gpu": gpu, "step_count": resumed.optimizer.step_count,
          "tensors_compared": len(trainer.model.state_dict()) + 3 * len(trainer.optimizer.params),
          "differing": diff[:8]})
    check(not diff and resumed.optimizer.step_count == sum(h["batches"] for h in hist),
          f"resumed state differs: {diff[:8]}")
    del resumed

    # best.ckpt served through the kernel
    pred = Predictor(str(out / "best.ckpt"), conf_threshold=0.25, iou_threshold=0.45,
                     max_det=300, dtype=torch.bfloat16, device=device)
    images = serving_images(seed=8, count=1)
    zero_launches()
    results = pred.predict_batch(images, batch_size=8)
    torch.cuda.synchronize()
    serve_launches = sq.spatial_quantize.launches
    serve_phi = phi_launches("resumed_serving", 3, bn=conv_bn_silu_modules(pred.model))
    emit({"phase": "resumed_serving", "gpu": gpu, "images": len(results),
          "avg_bits": round(results[0]["avg_bits"], 4),
          "launches": {"spatial_quant": serve_launches, "phi_tiles": serve_phi}})
    check(serve_launches == 3, f"best.ckpt served with {serve_launches} launches (expected 3)")
    for r in results:
        check(2.0 <= r["avg_bits"] <= 8.0 and np.isfinite(r["complexity_map"]).all(),
              "best.ckpt served a bad result")
    backend_parity(pred, images, device, "resumed_backend_parity")
    del pred

    # the host loader and the device pipeline alone; the idle share of an epoch
    host_ips = _images_per_s(DataLoader(trainer.train_dataset, batch, shuffle=True, seed=1,
                                        num_workers=2), device, DISK_TRAIN // batch)
    ds = trainer.train_dataset  # the same augmentation without HSV: its share of the loader
    ds_no_hsv = YOLODataset(ds.img_dir, img, ds.max_boxes, augment=True, hsv_p=0.0,
                            mosaic_p=ds.mosaic_p, cache_images=True)
    ds_no_hsv._img_cache = ds._img_cache  # decoded already: time the augmentation only
    no_hsv_ips = _images_per_s(DataLoader(ds_no_hsv, batch, shuffle=True, seed=1,
                                          num_workers=2), device, DISK_TRAIN // batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(DISK_EPOCHS - 1)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, n_kernels = _device_busy_ms(prof)
    epoch_ms = hist[-1]["train_s"] * 1e3
    del trainer

    dp_config = dict(config, epochs=1, output_dir=str(workdir / "disk_dp"),
                     curriculum={"enabled": False, "warmup_epochs": 0, "transition_epochs": 0},
                     data=dict(config["data"], device_pipeline=True))
    dp = Trainer(dp_config, device=device)
    pipe = dp._dev_train
    check(pipe.bank.device.type == device.type, "the device pipeline's bank is not on the card")
    clean_ds = YOLODataset(pipe.dataset.img_dir, img, 128)
    clean = np.stack([clean_ds.get_item(i)["image"] for i in range(len(pipe))])
    check(torch.equal(pipe.bank.cpu(), torch.from_numpy(clean)),
          "the device bank differs from the host loader's clean images")
    rng = np.random.default_rng(5)
    plan, labels = pipe._plan_batch(list(range(batch)), rng, True)
    idx4, mosaic_on, hsv_on, gains, s_, tx, ty, flip = plan
    check(mosaic_on.any() and hsv_on.any() and (s_ != 1).any() and flip.any(),
          "an augmentation never fired in the plan")
    dev_plan = [torch.from_numpy(a).to(device) for a in plan]
    aug = augment_batch(pipe.bank, *dev_plan)
    dev_plan[2] = torch.zeros_like(dev_plan[2])  # the same plan without HSV
    no_hsv = augment_batch(pipe.bank, *dev_plan)
    check(not torch.equal(aug, no_hsv), "HSV changed no pixel")
    moved = pipe._affine_labels(pipe.boxes[0], pipe.classes[0], s_[0], tx[0], ty[0])[0]
    check(len(pipe.boxes[0]) > 0 and (moved.shape != pipe.boxes[0].shape
                                      or not np.array_equal(moved, pipe.boxes[0])),
          "the affine did not move the boxes")
    dev_ips = _images_per_s(dp.train_loader, device, DISK_TRAIN // batch)
    t0 = time.perf_counter()
    dp_epoch = dp.train_epoch(DISK_EPOCHS - 1)
    torch.cuda.synchronize()
    dp_epoch_s = time.perf_counter() - t0
    emit({"phase": "device_pipeline", "gpu": gpu, "bank_images": len(pipe),
          "bank_bitwise_equal_host": True, "plan": {
              "mosaic": int(mosaic_on.sum()), "hsv_tiles": int(hsv_on.sum()),
              "affine_scale_range": [float(s_.min()), float(s_.max())],
              "flip": int(flip.sum())},
          "epoch": {k: dp_epoch[k] for k in ("stage", "loss_total", "loss_det", "avg_bits")},
          "epoch_s": dp_epoch_s, "train_images_per_s": dp_epoch["batches"] * batch / dp_epoch_s})
    check(all(np.isfinite(dp_epoch[k]) for k in LOSS_KEYS), "non-finite loss through the "
                                                           "device pipeline")
    del dp, pipe, aug, no_hsv

    emit({"phase": "data_throughput", "gpu": gpu,
          "host_loader_images_per_s": host_ips, "device_pipeline_images_per_s": dev_ips,
          "host_loader_without_hsv_images_per_s": no_hsv_ips,
          "host_loader": "DataLoader, num_workers 2, mosaic 1.0 + affine + HSV 0.5 + flip 0.5",
          "epoch_idle": {"profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                         "kernel_events": n_kernels,
                         "idle_share_profiled": 1.0 - busy_ms / prof_wall_ms,
                         "unprofiled_epoch_ms": epoch_ms,
                         "idle_share_unprofiled_epoch": 1.0 - busy_ms / epoch_ms},
          "timing": "host clock around synchronised work; idle: union of kernel intervals "
                    "(torch.profiler) over one Stage-3 epoch of the host loader"})
    return {"evaluate": counts["evaluate"][0], "val_loss": counts["val_loss"][0],
            "resumed_serving": serve_launches}


# ---------------------------------------------------------------------------
# Phase 7
# ---------------------------------------------------------------------------

CALIB_BATCHES, CALIB_BATCH = 4, 32  # 128 calibration images (the reference's default: 1000)
PERCENTILE_BATCH = 64  # P3 at 640 px: 26.2M elements, above torch.quantile's 2^24
CLI_IMAGES = 16
EXPORT_BATCH = 32
CV2_IMAGES = 16  # of phase 6's 128: the exact cv2 metrics take ~0.33 s per 640 px image
# The inference CLI's own process: `inference.main(argv)`, the entry of
# `python -m mcaq_yolo_tpu_torch.inference`, with the kernel's launch count
# zeroed just before it and read just after, and its wall time split into
# the import, the Predictor's construction and warm-up, and predict_batch.
# Prints that JSON as its last line.
CLI_RUN = """\
import json, sys, time
t0 = time.perf_counter()
import torch
from mcaq_yolo_tpu_torch import inference
from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
split = {"import_s": time.perf_counter() - t0}

def timed(name, fn):
    def run(self, *a, **k):
        n, m = sq.spatial_quantize.launches, ml.phi_tiles.launches
        t = time.perf_counter()
        out = fn(self, *a, **k)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        split[name + "_s"] = time.perf_counter() - t
        split[name + "_launches"] = sq.spatial_quantize.launches - n
        split[name + "_phi_launches"] = ml.phi_tiles.launches - m
        return out
    return run

P = inference.Predictor
P.__init__ = timed("predictor", P.__init__)
P._warmup = timed("warmup", P._warmup)
P.predict_batch = timed("predict_batch", P.predict_batch)
sq.spatial_quantize.launches = ml.phi_tiles.launches = 0
t = time.perf_counter()
inference.main(sys.argv[1:])
split["main_s"] = time.perf_counter() - t
split["launches"] = sq.spatial_quantize.launches
split["phi_launches"] = ml.phi_tiles.launches
print(json.dumps(split))
"""
MODES = ("minmax", "percentile", "entropy", "mse")
DEPLOY_META = {
    "epoch": 0, "variant": "yolov8n", "num_classes": 80, "img_size": IMG,
    "deploy_temperature": 1.0,
    "config": {"quantization": {"min_bits": 2, "max_bits": 8, "target_bits": 4.0,
                                "grid_size": 8, "bit_mapping": "mlp",
                                "monotone_param": "softplus", "normalize_complexity": False},
               "morphology": {"downsample": 2, "tile_engine": "lanes"}},
}


def _synced_s(fn):
    """(result, seconds) of fn() on the host clock, the card synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_convert(device, gpu: str):
    """7a: an Ultralytics-layout YOLOv8n (tests/torch_yolo_fixture.py, nc 80,
    seeded, random BatchNorm statistics) converted by `load_pretrained_into`;
    in float32 with TF32 off, the port's C3/C4/C5 and raw head maps
    (quantize=False) against the fixture's own forward on one 640 px batch.
    Returns the Ultralytics state_dict."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_yolo_fixture import TYOLOv8n, randomize_bn_stats, ultralytics_state_dict

    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.weights_io import load_pretrained_into

    torch.manual_seed(0)
    fixture = TYOLOv8n(nc=80, variant="yolov8n")
    with torch.no_grad():
        randomize_bn_stats(fixture, torch.Generator().manual_seed(1))
    fixture = fixture.eval().to(device)
    sd = ultralytics_state_dict(fixture)
    model, convert_s = _synced_s(lambda: load_pretrained_into(
        MCAQYOLO(num_classes=80, morph_downsample=2, device=device, seed=0), sd))
    g = torch.Generator(device=device).manual_seed(2)
    x = torch.rand((8, IMG, IMG, 3), generator=g, device=device)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            nchw = x.permute(0, 3, 1, 2).contiguous()
            ref_feats = fixture.backbone_features(nchw)
            ref_maps = [m.permute(0, 2, 3, 1) for m in fixture(nchw)]
            feats = model.backbone_features(x)
            maps, _ = model(x, quantize=False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    errs = {}
    for name, a, b in [(f"C{i + 3}", f, r) for i, (f, r) in enumerate(zip(feats, ref_feats))] + \
            [(f"raw_P{i + 3}", m, r) for i, (m, r) in enumerate(zip(maps, ref_maps))]:
        d = (a.float() - b.float()).abs()
        errs[name] = {"max_abs": float(d.max()), "max_ref": float(b.abs().max()),
                      "max_rel": float((d / (b.abs() + 1e-3)).max())}
    ok = all(e["max_abs"] <= 1e-3 * max(1.0, e["max_ref"]) for e in errs.values())
    emit({"phase": "convert_ultralytics", "gpu": gpu, "batch": 8, "img_size": IMG,
          "dtype": "float32, TF32 off", "convert_s": convert_s, "keys": len(sd), "errors": errs,
          "tolerance": "max abs error <= 1e-3 x max(1, max |fixture|) per map"})
    check(ok, f"converted YOLOv8n differs from the Ultralytics-layout forward: {errs}")
    del fixture, model
    return sd


def phase_deploy(device, workdir: Path, gpu: str, sd, disk_dir: Path):
    """7b-f: calibrate the converted model in each calibration mode, serve,
    export, the inference CLI, and the cv2 scoring backend."""
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.calibrate import calibrate
    from mcaq_yolo_tpu_torch.data.dataset import letterbox, read_image, write_image
    from mcaq_yolo_tpu_torch.export import (
        count_phi_nodes, count_quant_nodes, export_inference, load_exported, make_inference_fn)
    from mcaq_yolo_tpu_torch.inference import Predictor
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.weights_io import (
        load_jax_variables, load_pretrained_into, to_jax_variables)
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint
    from mcaq_yolo_tpu_torch.utils.cuda_timing import cuda_ms

    dtype = torch.bfloat16
    base = load_pretrained_into(MCAQYOLO(num_classes=80, morph_downsample=2, dtype=dtype,
                                         device=device, seed=0), sd)
    base = to_jax_variables(spread_model(base, device, dtype, seed=0))
    g = torch.Generator(device=device).manual_seed(3)
    calib = [{"image": torch.randint(0, 256, (CALIB_BATCH, IMG, IMG, 3), generator=g,
                                     device=device, dtype=torch.uint8)}
             for _ in range(CALIB_BATCHES)]
    pool = serving_images(seed=9, count=PERCENTILE_BATCH // 8)
    letterboxed = torch.from_numpy(np.stack([letterbox(im, IMG)[0] for im in pool])).to(device)
    launches, ckpts = {}, {}
    for mode in MODES:
        model = MCAQYOLO(num_classes=80, calibration_mode=mode, morph_downsample=2,
                         dtype=dtype, device=device, seed=0)
        load_jax_variables(model, base)
        torch.cuda.reset_peak_memory_stats(device)
        zero_launches()
        _, calib_s = _synced_s(lambda: calibrate(model, calib,
                                                 num_images=CALIB_BATCHES * CALIB_BATCH))
        n = sq.spatial_quantize.launches
        n_phi = phi_launches(f"calibration_{mode}", 3 * CALIB_BATCHES,
                             bn=CALIB_BATCHES * conv_bn_silu_modules(model))
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        state = [(int(q.num_batches), bool(q.frozen)) for q in model.quantizers]
        check(n == 3 * CALIB_BATCHES, f"{mode}: calibration launched the kernel {n} times "
                                      f"(expected {3 * CALIB_BATCHES})")
        check(state == [(CALIB_BATCHES, True)] * 3, f"{mode}: calibration state {state}")
        if mode == "entropy":
            check(all(abs(float(q.histogram.sum()) - 1.0) < 1e-3 for q in model.quantizers),
                  "entropy: the EMA histogram does not sum to 1")
        path = workdir / f"deploy_{mode}.ckpt"
        save_checkpoint(path, to_jax_variables(model), DEPLOY_META)
        ckpts[mode] = path
        batch = PERCENTILE_BATCH if mode == "percentile" else 8
        eval_launches = model_parity(model, letterboxed[:batch], f"calibrated_{mode}_parity")
        if mode == "mse":
            lo, hi = model.quantizers[0].calibration_range(
                model.backbone_features(letterboxed[:8])[0].permute(0, 2, 3, 1))
            check(tuple(lo.shape) == (7, 1), f"mse ranges {tuple(lo.shape)}, expected (7, 1)")
        launches[f"calibration_{mode}"] = n
        row = {"mode": mode, "calibration_s": calib_s, "images": CALIB_BATCHES * CALIB_BATCH,
               "calibration_images_per_s": CALIB_BATCHES * CALIB_BATCH / calib_s,
               "peak_mem_GB": peak, "launches": n, "phi_launches": n_phi,
               "eval_forward_batch": batch,
               "eval_forward_launches": eval_launches}
        emit({"phase": "calibrate", "gpu": gpu, **row})
        del model
    torch.cuda.empty_cache()

    # c. serve the minmax checkpoint
    pred = Predictor(str(ckpts["minmax"]), conf_threshold=0.25, iou_threshold=0.45,
                     max_det=300, dtype=dtype, device=device)
    images = serving_images(seed=10, count=1)
    zero_launches()
    results = pred.predict_batch(images, batch_size=8)
    torch.cuda.synchronize()
    launches["deployed_serving"] = sq.spatial_quantize.launches
    phi_launches("deployed_serving", 3, bn=conv_bn_silu_modules(pred.model))
    check(launches["deployed_serving"] == 3, f"serving launched the kernel "
                                             f"{launches['deployed_serving']} times (expected 3)")
    for r in results:
        check(2.0 <= r["avg_bits"] <= 8.0 and np.isfinite(r["complexity_map"]).all(),
              "the converted model served a bad result")
    emit({"phase": "deployed_serving", "gpu": gpu, "images": len(results),
          "detections": sum(len(r["detections"]) for r in results),
          "avg_bits": round(results[0]["avg_bits"], 4), "launches": launches["deployed_serving"]})
    backend_parity(pred, images, device, "deployed_backend_parity")

    # d. export, save, load in this process, against the eager program
    model = pred.model
    xb = torch.rand((EXPORT_BATCH, IMG, IMG, 3), generator=g, device=device)
    exported, export_s = _synced_s(lambda: export_inference(model, batch_size=EXPORT_BATCH,
                                                            img_size=IMG, with_nms=True))
    nodes = count_quant_nodes(exported)
    phi_nodes = count_phi_nodes(exported)
    blob = workdir / "mcaq_yolo.pt2"
    torch.export.save(exported, str(blob))
    del exported
    program, load_s = _synced_s(lambda: load_exported(blob))
    eager = make_inference_fn(model)
    with torch.no_grad():
        ref = eager(xb)
        zero_launches()
        out = program(xb)
        torch.cuda.synchronize()
        launches["exported_program"] = sq.spatial_quantize.launches
        phi_launches("exported_program", 3, bn=conv_bn_silu_modules(model))
    same = [bool(torch.equal(a, b)) for a, b in zip(out, ref)]
    with torch.no_grad():
        loaded_ms = cuda_ms(lambda k: program(xb))
        eager_ms = cuda_ms(lambda k: eager(xb))
    emit({"phase": "export", "gpu": gpu, "batch": EXPORT_BATCH, "img_size": IMG, "nodes": nodes,
          "phi_nodes": phi_nodes, "phi_launches": PHI_LAUNCHES["exported_program"],
          "export_s": export_s, "load_s": load_s, "artifact_MB": blob.stat().st_size / 1e6,
          "bitwise_equal": dict(zip(("boxes", "scores", "classes", "valid", "avg_bits"), same)),
          "detections": int(ref[3].sum()), "launches": launches["exported_program"],
          "loaded_ms": loaded_ms, "eager_ms": eager_ms,
          "loaded_images_per_s": EXPORT_BATCH / (loaded_ms * 1e-3),
          "eager_images_per_s": EXPORT_BATCH / (eager_ms * 1e-3),
          "timing": "CUDA events around one call, median of 21"})
    check(nodes == 3, f"the exported graph holds {nodes} spatial_quantize nodes (expected 3)")
    check(phi_nodes == 3, f"the exported graph holds {phi_nodes} phi_tiles nodes (expected 3)")
    check(all(same), f"the loaded program differs from the eager one: {same}")
    check(launches["exported_program"] == 3, "one call of the loaded program launched the "
          f"kernel {launches['exported_program']} times (expected 3)")
    del program, pred, model, xb

    # e. the inference CLI on a directory, against predict_batch in this process
    src = workdir / "cli_images"
    src.mkdir()
    rng = np.random.default_rng(11)
    for i in range(CLI_IMAGES):
        h, w = [(480, 640), (640, 480), (500, 500), (360, 640)][i % 4]
        write_image(src / f"im{i:02d}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    out_json = workdir / "cli.json"
    args = ["--model", str(ckpts["minmax"]), "--source", str(src), "--output", str(out_json)]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", CLI_RUN, *args], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(r.returncode == 0, f"the inference CLI failed: {r.stderr[-2000:]}")
    run = json.loads(r.stdout.strip().splitlines()[-1])
    launches["inference_cli"] = run["launches"]
    PHI_LAUNCHES["inference_cli"] = run["phi_launches"]
    check(run["phi_launches"] == 9 and run["predict_batch_phi_launches"] == 3,
          f"the CLI's run launched the phi kernel {run['phi_launches']} times (expected 9)")
    summary = json.loads(out_json.read_text())
    files = sorted(str(p) for p in src.glob("*.png"))
    # the CLI process runs with PyTorch's default cuDNN settings
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
    try:
        cli_pred = Predictor(str(ckpts["minmax"]), img_size=IMG, num_classes=80, device=device)
        in_process = cli_pred.predict_batch([read_image(f) for f in files])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = flags
    mism = [f for f, res in zip(files, in_process)
            if summary["results"].get(f, {}).get("num_detections") != len(res["detections"])
            or summary["results"][f]["avg_bits"] != res["avg_bits"]]
    emit({"phase": "inference_cli", "gpu": gpu, "images": summary["num_images"],
          "cli_wall_s": cli_s, "split": run, "launches": run["launches"],
          "detections": sum(len(x["detections"]) for x in in_process),
          "mismatched_images": mism,
          "timing": "host clock: the process's wall, and in it the import, Predictor "
                    "construction (its warm-up included), the warm-up, predict_batch, main()"})
    check(summary["num_images"] == CLI_IMAGES and not mism,
          f"the CLI's JSON disagrees with predict_batch on {mism}")
    # one chunk of CLI_IMAGES (predict_batch's default batch) after the
    # Predictor's two warm-up forwards, 3 launches each
    check(run["warmup_launches"] == 6 and run["predict_batch_launches"] == 3
          and run["launches"] == 9, f"the CLI's run launched the kernel {run} (expected "
                                    "6 in the warm-up, 3 in predict_batch, 9 in all)")
    del cli_pred
    cmd = [sys.executable, "-m", "mcaq_yolo_tpu_torch.inference", *args[:2]]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        emit({"phase": "inference_cli_visualize", "gpu": gpu,
              "skipped": "matplotlib is not installed on this host"})
    else:
        vis = workdir / "cli_vis"
        vis_cmd = cmd + ["--source", files[0], "--visualize", "--output-dir", str(vis)]
        r = subprocess.run(vis_cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        made = sorted(p.name for p in vis.glob("*.png")) if vis.exists() else []
        emit({"phase": "inference_cli_visualize", "gpu": gpu, "files": made})
        check(r.returncode == 0 and made == ["bits.png", "complexity.png"],
              f"the CLI's --visualize run failed: {r.stderr[-2000:]}")

    # f. the exact cv2 scoring backend over the first CV2_IMAGES of phase 6's
    # training images (copied with their labels into a split of their own)
    import shutil

    from mcaq_yolo_tpu_torch.core.morphology_cv2 import score_image_cv2
    from mcaq_yolo_tpu_torch.train import Trainer

    subset = workdir / "cv2_subset"
    for kind in ("images", "labels"):
        (subset / kind / "train").mkdir(parents=True)
    for img in sorted((disk_dir / "images" / "train").iterdir())[:CV2_IMAGES]:
        shutil.copy(img, subset / "images" / "train" / img.name)
        label = disk_dir / "labels" / "train" / (img.stem + ".txt")
        if label.exists():
            shutil.copy(label, subset / "labels" / "train" / label.name)
    config = {"epochs": 1, "batch_size": TRAIN_BATCH, "seed": 0,
              "output_dir": str(workdir / "cv2_scores"),
              "model": {"name": "yolov8n", "num_classes": 80},
              "data": {"train": str(subset / "images" / "train"),
                       "val": str(subset / "images" / "train"), "img_size": IMG,
                       "max_boxes": 128, "cache": False},
              "morphology": {"downsample": 2}, "distillation": {"enabled": False},
              "curriculum": {"score_backend": "cv2"}}
    trainer = Trainer(config, device=device)  # scores the split with the cv2 backend
    scoring = trainer._scoring_dataset()
    imgs = np.stack([scoring.get_item(i)["image"] for i in range(len(scoring))])
    t0 = time.perf_counter()
    direct = score_image_cv2(imgs)
    score_s = time.perf_counter() - t0
    equal = bool(np.array_equal(trainer.complexity_scores, direct.astype(np.float32)))
    emit({"phase": "cv2_scoring", "gpu": gpu, "images": len(imgs), "scoring_s": score_s,
          "images_per_s": len(imgs) / score_s, "equal": equal,
          "timing": "host clock around score_image_cv2 on the split's letterboxed images",
          "score_range": [float(direct.min()), float(direct.max())]})
    check(equal and len(imgs) == CV2_IMAGES, "cv2 scores from the Trainer differ from "
                                             "score_image_cv2")
    return launches


# ---------------------------------------------------------------------------
# Phase 8
# ---------------------------------------------------------------------------

EVIDENCE_SCRIPTS = (  # name, batch size, quantized forwards per batch
    ("m3_permutation", 8, 4), ("m4_variation_gain", 4, 2),
    ("downsample_fidelity", 16, 4), ("pretopk_equivalence", 16, 1))


def _counting_forwards():
    """Patch MCAQYOLO so that every quantized eval forward is counted (the
    scripts build their models inside `run`); returns (counter, undo)."""
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    counter, orig = [0], MCAQYOLO._forward

    def _forward(self, x, temperature, quantize, training, *rest):
        counter[0] += int(quantize and not training)
        return orig(self, x, temperature, quantize, training, *rest)

    MCAQYOLO._forward = _forward
    return counter, lambda: setattr(MCAQYOLO, "_forward", orig)


def phase_evidence_scripts(device, workdir: Path, gpu: str):
    """The evidence scripts on phase 6's best.ckpt and its 32-image val split
    (640 px): (a) `apply_external_bit_maps` with the model's own maps is the
    normal quantized forward, bitwise, in 3 launches; (b) permuted and
    constant maps give bitwise-equal raw maps through the kernel and the
    plain version; (c) M3, M4 (200 bootstrap reps), downsample_fidelity and
    pretopk_equivalence end with finite numbers, each with 3 launches per
    quantized forward and the forwards its batches imply; (d) `batched_nms`
    on one decoded batch equals `decode_and_nms` at the same gate and pool
    (the same valid set and classes, boxes and scores within 1e-6
    relative), both timed."""
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.data.dataset import YOLODataset
    from mcaq_yolo_tpu_torch.inference import Predictor
    from mcaq_yolo_tpu_torch.models.yolo import decode_and_nms, decode_predictions
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.ops.nms import batched_nms
    from mcaq_yolo_tpu_torch.scripts import (downsample_fidelity, m3_permutation,
                                             m4_variation_gain, pretopk_equivalence)
    from mcaq_yolo_tpu_torch.utils.cuda_timing import cuda_ms

    ckpt = str(workdir / "disk" / "best.ckpt")
    data_yaml = str(workdir / "ds" / "dataset.yaml")
    pred = Predictor(ckpt, warmup=False, device=device)
    model, nc = pred.model, pred.num_classes
    val = YOLODataset(str(workdir / "ds" / "images" / "val"), IMG)
    x = torch.from_numpy(np.stack([val.get_item(i)["image"] for i in range(8)])).to(device)

    def launched(fn):
        torch.cuda.synchronize()
        zero_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, sq.spatial_quantize.launches

    with torch.inference_mode():
        raw, aux = model(x, temperature=pred.deploy_temperature, quantize=True)
        own = aux["bit_map"]
        ext, n_own = launched(lambda: m3_permutation.apply_external_bit_maps(model, x, own))
        check(n_own == 3, f"the external-map forward launched {n_own} times (expected 3)")
        # the maps replace the analyzer; the float32 network runs once
        phi_launches("external_bit_maps", 0, bn=conv_bn_silu_modules(model),
                     cf=conv_bn_silu_modules(model))
        check(all(torch.equal(a, b) for a, b in zip(raw, ext)),
              "apply_external_bit_maps with the model's own maps differs from its forward")

        maps = {"permuted": [torch.as_tensor(np.stack([
                    m3_permutation.permute_bit_map(m[i], "permuted", i)
                    for i in range(m.shape[0])]), device=device)
                    for m in (b.cpu().numpy() for b in own)],
                "constant": [torch.full_like(b, 3.0) for b in own]}
        arms = {}
        for name, mp in maps.items():
            out, n_kernel = launched(lambda: m3_permutation.apply_external_bit_maps(model, x, mp))
            model.set_quant_backend("torch")
            try:
                plain, n_plain = launched(
                    lambda: m3_permutation.apply_external_bit_maps(model, x, mp))
            finally:
                model.set_quant_backend("auto")
            same = all(torch.equal(a, b) for a, b in zip(out, plain))
            arms[name] = {"launches": n_kernel, "plain_launches": n_plain, "bitwise": same,
                          "changed_raw_maps": not all(torch.equal(a, b)
                                                      for a, b in zip(out, raw))}
            check(same and n_kernel == 3 and n_plain == 0,
                  f"{name} maps: kernel vs plain {arms[name]}")

        # (d) the separate NMS path against the fused one, same gate and pool
        nms_rows = {}
        for conf in (0.001, 1e-7):
            kw = dict(conf_threshold=conf, iou_threshold=0.65, max_det=300, pre_topk=1024)

            def separate(k=0):
                boxes, scores, _, _ = decode_predictions(raw, nc)
                return batched_nms(boxes, scores, **kw)

            def fused(k=0):
                return decode_and_nms(raw, nc, **kw)

            a, b = separate(), fused()
            v = a[3]  # the padding rows past the survivors hold whatever sorted there
            same = torch.equal(v, b[3]) and torch.equal(a[2][v], b[2][v])
            # sigmoid of (B, A, nc) against sigmoid of the (B, k) winners: the
            # card may round them differently by an ulp
            diff = {k: float((a[i][v] - b[i][v]).abs().max()) if v.any() else 0.0
                    for i, k in ((0, "boxes"), (1, "scores"))}
            same = same and all(torch.allclose(a[i][v], b[i][v], rtol=1e-6, atol=0)
                                for i in (0, 1))
            nms_rows[str(conf)] = {"equal": same, "max_abs_diff": diff,
                                   "detections": int(a[3].sum()),
                                   "batched_nms_ms": cuda_ms(separate, reps=11),
                                   "decode_and_nms_ms": cuda_ms(fused, reps=11)}
            check(same, f"batched_nms differs from decode_and_nms at conf {conf}")
    modules = conv_bn_silu_modules(model)  # the scripts build the same YOLOv8n
    del pred, model
    emit({"phase": "external_bit_maps", "gpu": gpu, "batch": int(x.shape[0]),
          "own_maps": {"launches": n_own, "bitwise_equal_forward": True}, **arms,
          "nms_paths": nms_rows,
          "timing": "decode + NMS alone on one batch's raw maps, CUDA events around one "
                    "call, host included, median of 11"})

    # (c) the scripts, each counted: launches = 3 x the quantized forwards
    n_val = len(list((workdir / "ds" / "images" / "val").iterdir()))
    runs = {
        "m3_permutation": lambda bs: m3_permutation.run(
            ckpt, data_yaml, IMG, nc, batch_size=bs, device=device),
        "m4_variation_gain": lambda bs: m4_variation_gain.run(
            ckpt, data_yaml, IMG, nc, batch_size=bs, reps=200, device=device),
        "downsample_fidelity": lambda bs: downsample_fidelity.run(
            ckpt, data_yaml, IMG, num_classes=nc, batch_size=bs, device=device),
        "pretopk_equivalence": lambda bs: pretopk_equivalence.run(
            ckpt, data_yaml, batch_size=bs, device=device),
    }
    launches = {}
    for name, bs, per_batch in EVIDENCE_SCRIPTS:
        counter, undo = _counting_forwards()
        try:
            (res, n_launch), s = _synced_s(lambda: launched(lambda: runs[name](bs)))
        finally:
            undo()
        # downsample_fidelity's loader drops a ragged tail, the others keep it
        n_batches = n_val // bs if name == "downsample_fidelity" else -(-n_val // bs)
        expected = n_batches * per_batch
        # the scripts' float32 networks: one conv_f32 a ConvBnSiLU a forward
        n_phi = phi_launches(f"script_{name}", cf=modules * expected)
        emit({"phase": f"script_{name}", "gpu": gpu, "batch": bs, "wall_s": s,
              "launches": n_launch, "phi_launches": n_phi, "quantized_forwards": counter[0],
              "result": res})
        check(counter[0] == expected and n_launch == 3 * expected,
              f"{name}: {n_launch} launches in {counter[0]} quantized forwards "
              f"(expected {expected} forwards)")
        numbers = list(_numbers(res))
        check(numbers and all(np.isfinite(v) for v in numbers),
              f"{name}: a non-finite result {res}")
        launches[name] = n_launch
    return {"external_bit_maps": n_own, **{f"{k}_maps": v["launches"] for k, v in arms.items()},
            **launches}


# ---------------------------------------------------------------------------
# Phase 9
# ---------------------------------------------------------------------------

DIAG_ITERS = 15         # timed rounds of the sub-programs (after 3 warm-up rounds)
DIAG_BATCHES = (32, 256)
ROOFLINE_BATCH = 256
SWEEP_BATCHES = (32, 64)
MORPH_SCALES = (("P3", 80, 8), ("P4", 40, 4), ("P5", 20, 2))
# (corpus, metric_mode, legacy): both corpora in the deployed mode, the two
# ablation arms on the synthetic one (the full-size run covers all six)
AGREEMENT_ARMS = (("synthetic", "tiled", False), ("natural", "tiled", False),
                  ("synthetic", "tiled", True), ("synthetic", "global", False))
R4_FUSED_PEARSON = {"synthetic": 0.970, "natural": 0.917}  # evidence/r4, JAX on a TPU


def _counting_quantized_transforms():
    """Patch MCAQYOLO.mcaq_transform so that every quantizing eval call (one
    spatial_quant launch on the card) is counted; returns (counter, undo)."""
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    counter, orig = [0], MCAQYOLO.mcaq_transform

    def mcaq_transform(self, feat, scale_idx, temperature, quantize, training=False, *a, **k):
        counter[0] += int(quantize and not training)
        return orig(self, feat, scale_idx, temperature, quantize, training, *a, **k)

    MCAQYOLO.mcaq_transform = mcaq_transform
    return counter, lambda: setattr(MCAQYOLO, "mcaq_transform", orig)


def _path_launches(name, fn, forwards=None):
    """Run fn with the launch count zeroed before and read after, the
    quantizing transforms counted; check launches = 3 x the quantized
    forwards (= transforms / 3), and that there were `forwards` of them
    when given; the phi kernel's launches recorded under `name`.  Returns
    (result, launches, seconds)."""
    import torch

    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq

    counter, undo = _counting_quantized_transforms()
    try:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = sq.spatial_quantize.launches
        PHI_LAUNCHES[name] = ml.phi_tiles.launches
    finally:
        undo()
    check(launches == counter[0] and counter[0] % 3 == 0,
          f"{name}: {launches} launches in {counter[0]} quantizing transforms")
    if forwards is not None:
        check(counter[0] == 3 * forwards,
              f"{name}: {counter[0] // 3} quantized forwards, expected {forwards}")
    return out, launches, seconds


def phase_diagnostics(device, gpu: str, workdir: Path):
    """The profiling layer and the morphology options on the card: (a)
    `component_breakdown(cost=True)` at bs 32 and 256 (640 px, bf16,
    `seeded_model`), its `with_mcaq` features bitwise equal to the ones
    the forward feeds the neck, through the kernel and through the plain
    version; (b) `roofline.run` at bs 256, every stage's bound <= its time;
    (c) a short `perf_sweep_diag` sweep; (d) `profile_morphology.run` at P3
    / P4 / P5 (bs 32) with each operator's kernel count; (e)
    `train_breakdown.run` at yolov8n, bs 16 (phase 5's config); (f)
    `backend_agreement.run` on the synthetic and natural corpora (16 images,
    256 px), and the legacy and global arms on the synthetic one; (g)
    `utils.profiling.trace` of one forward.  Launches: 3 per quantized forward on (a)-(c), none on
    (d)-(f)."""
    import json as _json

    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.scripts import (backend_agreement, perf_sweep_diag,
                                             profile_morphology, roofline, train_breakdown)
    from mcaq_yolo_tpu_torch.utils import profiling

    torch.backends.cudnn.deterministic = False
    dtype = torch.bfloat16
    model = seeded_model(device, dtype)
    progs = profiling.breakdown_programs(model)
    rng = np.random.default_rng(9)
    launches = {}
    per_call = 2 * (3 + DIAG_ITERS + 1)  # full and with_mcaq: warm-up, timed, cost pass
    # roofline: that, then the full forward and the deployed program in turns, and
    # the deployed program's cost pass

    for bs in DIAG_BATCHES:
        x = torch.from_numpy(rng.integers(0, 256, (bs, IMG, IMG, 3), dtype=np.uint8)).to(device)
        bd, n, s = _path_launches(
            f"component_breakdown_bs{bs}",
            lambda: profiling.component_breakdown(model, x, iters=DIAG_ITERS, cost=True),
            forwards=per_call)
        launches[f"component_breakdown_bs{bs}"] = n
        stages = ("backbone", "morphology", "bitmap_quantize", "neck_head")
        check(all(np.isfinite(bd[f"{k}_ms"]) for k in ("full",) + stages),
              f"component_breakdown bs {bs}: a non-finite time {bd}")
        check(bd["full_gflops"] > 0 and bd["backbone_gb_floor"] > 0,
              f"component_breakdown bs {bs}: no FLOPs or bytes counted")
        same = {}
        with torch.inference_mode():
            for backend in ("auto", "torch"):
                model.set_quant_backend(backend)
                _, aux = progs["full"](x)
                q = progs["with_mcaq"](x)
                same[backend] = (aux["quantized_features"], q)
            model.set_quant_backend("auto")
        bitwise = {b: all(torch.equal(a.view(torch.int16), c.view(torch.int16))
                          for a, c in zip(*same[b])) for b in same}
        bitwise["kernel_vs_plain"] = all(
            torch.equal(a.view(torch.int16), c.view(torch.int16))
            for a, c in zip(same["auto"][1], same["torch"][1]))
        emit({"phase": "component_breakdown", "gpu": gpu, "batch": bs, "img_size": IMG,
              "dtype": str(dtype), "iters": DIAG_ITERS, "wall_s": s, "launches": n,
              "with_mcaq_bitwise": bitwise, **bd})
        check(all(bitwise.values()),
              f"bs {bs}: with_mcaq's features differ from the forward's: {bitwise}")
        del x, same

    res, n, s = _path_launches(
        "roofline", lambda: roofline.run(batch=ROOFLINE_BATCH, iters=DIAG_ITERS, device=device),
        forwards=per_call + 2 * (3 + DIAG_ITERS) + 1)
    launches["roofline"] = n
    emit({"phase": "roofline", "gpu": gpu, "wall_s": s, "launches": n, **res})
    for row in res["stages"]:
        check(np.isfinite(row["ms"]) and row["bound_ms"] <= row["ms"],
              f"roofline stage {row['stage']}: bound {row['bound_ms']} ms, measured "
              f"{row['ms']} ms")

    res, n, s = _path_launches(
        "perf_sweep_diag", lambda: perf_sweep_diag.run(list(SWEEP_BATCHES), iters=2,
                                                       device=device),
        forwards=2 * (3 + 2 + 1) + 2 * (3 + 2))
    launches["perf_sweep_diag"] = n
    emit({"phase": "perf_sweep_diag", "gpu": gpu, "wall_s": s, "launches": n, **res})
    check(all(np.isfinite(v) for r in res["sweep"].values() for v in r["ms"].values()),
          "perf_sweep_diag: a non-finite time")

    n_morph = 0
    for name, hw, tile in MORPH_SCALES:
        res, n, s = _path_launches(
            f"profile_morphology_{name}",
            lambda: profile_morphology.run(batch=32, hw=hw, tile=tile, iters=DIAG_ITERS,
                                           device=device), forwards=0)
        n_morph += n
        emit({"phase": "profile_morphology", "gpu": gpu, "scale": name, "wall_s": s,
              "launches": n, **res})
        kernels = res["cuda_kernels"]
        # every operator timed and its kernels counted exactly (each count is
        # that of two CUDA graph captures, which `cuda_kernels` holds equal)
        check(all(isinstance(v, int) and v > 0 for v in kernels.values())
              and all(res[k] > 0 for k in kernels), f"profile_morphology {name}: {res}")
        check(kernels["phi_lanes"] == 1, f"profile_morphology {name}: the fused phi took "
                                         f"{kernels['phi_lanes']} kernels")
    launches["profile_morphology"] = n_morph

    res, n, s = _path_launches(
        "train_breakdown", lambda: train_breakdown.run("yolov8n", batch=TRAIN_BATCH, img=IMG,
                                                       iters=3, device=device), forwards=0)
    launches["train_breakdown"] = n
    emit({"phase": "train_breakdown", "gpu": gpu, "wall_s": s, "launches": n, **res})
    check(all(np.isfinite(v) for v in res["raw_ms"].values()), "train_breakdown: a bad time")
    check(res["step_ops"].get("aten.convolution_backward", 0) > 0
          and res["step_bound_ms"] <= res["raw_ms"]["full_step_ms"],
          f"train_breakdown: backward not counted or bound above the step: {res}")

    n_agree = 0
    for corpus, mode, legacy in AGREEMENT_ARMS:
        res, n, s = _path_launches(
            f"backend_agreement_{corpus}_{mode}" + ("_legacy" if legacy else ""),
            lambda: backend_agreement.run(
                num_images=16, img_size=256, legacy=legacy, metric_mode=mode,
                corpus=corpus, device=device), forwards=0)
        n_agree += n
        fused = res["fused"]["pearson"]
        emit({"phase": "backend_agreement", "gpu": gpu, "wall_s": s, "launches": n,
              "r4_fused_pearson": R4_FUSED_PEARSON[corpus] if not legacy
              and mode == "tiled" else None, **res})
        check(np.isfinite(fused), f"backend_agreement {corpus} {mode} legacy={legacy}: "
                                  f"fused Pearson {fused}")
    launches["backend_agreement"] = n_agree
    # every path of this phase runs the model's or the metrics' 'lanes' engine
    # but the global-mode agreement arm
    for path in [p for p in PHI_LAUNCHES if p.startswith((
            "component_breakdown", "roofline", "perf_sweep_diag", "profile_morphology",
            "train_breakdown", "backend_agreement"))]:
        check(PHI_LAUNCHES[path] > 0 or path.endswith("_global"),
              f"{path}: the phi kernel never launched")

    x = torch.from_numpy(rng.integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)).to(device)
    with torch.inference_mode(), profiling.trace(str(workdir / "trace")) as log_dir:
        model(x)
        torch.cuda.synchronize()
    events = _json.loads((Path(log_dir) / "trace.json").read_text())["traceEvents"]
    n_kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
    emit({"phase": "trace", "gpu": gpu, "events": len(events), "kernel_events": n_kernels})
    check(n_kernels > 0, "the trace holds no CUDA kernel")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: multi-device training and serving
# ---------------------------------------------------------------------------

MD_RANKS = 2            # processes sharing the one card over gloo
MD_SERVE, MD_CHUNK = 32, 11   # DP serving: 32 images, chunks of 11 (rounded up to 12)
# bounds of the 2-rank programs against the one-rank program on the same
# global batch (float32, TF32 off, deterministic cuDNN): the first step's
# loss; the parameters after the steps, |theta_2 - theta_1| over the steps'
# own movement |theta_1 - theta_0| (AdamW's update is normalized per
# element, so a gradient that a quantization step flips in Stage 3 moves
# its element by ~lr the other way; the raw relative L2 is printed too);
# the BatchNorm running statistics (max |diff| over max |x|); the serving
# confidences (JAX's DP bound, tests/test_parallel.py:171)
MD_LOSS_RTOL, MD_STEP_REL, MD_STATS_RTOL = 1e-4, 5e-2, 1e-3
MD_CONF_RTOL, MD_CONF_ATOL = 2e-5, 2e-6


def _md_train(mode: str, work: Path, device, teacher: str, mesh):
    """Phase 5's training config in float32 over three one-batch epochs
    (Stage 1, then Stage 3 twice) on this rank's rows of the global batch
    of 16: the per-epoch metrics, the parameters and BatchNorm statistics
    after, and (fsdp) the placed fraction of parameter elements."""
    import numpy as np

    from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
    from mcaq_yolo_tpu_torch.models.weights_io import param_leaves, to_jax_variables
    from mcaq_yolo_tpu_torch.train import Trainer

    config = {
        "epochs": 3, "batch_size": TRAIN_BATCH, "learning_rate": 1e-3, "seed": 0,
        "output_dir": str(work / f"train_{mode}"),
        "model": {"name": "yolov8n", "num_classes": 80, "teacher_path": teacher},
        "data": {"img_size": IMG, "max_boxes": 128}, "morphology": {"downsample": 2},
        "quantization": {"bit_mapping": "mlp", "monotone_param": "softplus"},
        "curriculum": {"warmup_epochs": 0, "transition_epochs": 0},
        "scheduler": {"warmup_epochs": 1}, "distillation": {"enabled": True},
        "training": {"amp": False, "parallel": mode},
    }
    batches = synthetic_batches(1, TRAIN_BATCH, IMG, 80, max_boxes=128,
                                boxes_per_image=(5, 30), seed=3)
    trainer = Trainer(config, batches, device=device)
    flat = lambda tree: np.concatenate([np.asarray(v, np.float64).ravel()  # noqa: E731
                                        for v in _tree_leaves(tree)])
    start = flat(to_jax_variables(trainer.model)["params"])
    epochs = [trainer.train_epoch(e) for e in range(3)]
    leaves = [p for _, p, _ in param_leaves(trainer.model)]
    placed = sum(p.numel() for p in leaves if hasattr(p, "placements")) / sum(
        p.numel() for p in leaves)
    variables = to_jax_variables(trainer.model)  # whole tensors (a collective under fsdp)
    return {"epochs": epochs, "start": start, "params": flat(variables["params"]),
            "stats": flat(variables["batch_stats"]), "placed_fraction": placed,
            "rule_fraction": _rule_fraction(trainer)}


def _tree_leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_tree_leaves(v) if isinstance(v, dict) else [v])


def _rule_fraction(trainer) -> float:
    """The fraction of parameter elements the FSDP rule shards on this mesh."""
    from mcaq_yolo_tpu_torch.parallel import fsdp
    from mcaq_yolo_tpu_torch.parallel.mesh import mesh_size

    dims = fsdp.fsdp_shardings(trainer.model, trainer.mesh)
    n = sum(p.numel() for p in dims)
    return 0.0 if mesh_size(trainer.mesh) == 1 else sum(
        p.numel() for p, d in dims.items() if d is not None) / n


def _md_cases(work: Path, device, mesh, inputs: dict) -> dict:
    """Every part of phase 10 on this rank (one rank: mesh None), each
    part's wall seconds and spatial_quant launches counted from 0 just
    before it."""
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.data.dataset import DataLoader, YOLODataset
    from mcaq_yolo_tpu_torch.inference import Predictor
    from mcaq_yolo_tpu_torch.models.weights_io import COLLECTIONS, load_jax_variables
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.train import Trainer
    from mcaq_yolo_tpu_torch.utils.checkpoint import load_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # no atomics in the backward
    out, wall = {}, {}

    def timed_part(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        wall[name] = round(time.perf_counter() - t0, 3)

    for mode in ("dp", "fsdp") if mesh is not None else ("dp",):
        timed_part(mode, lambda: _md_train(mode, work, device, inputs["teacher"], mesh))

    def serve():
        pred = Predictor(inputs["serve_ckpt"], conf_threshold=0.25, iou_threshold=0.45,
                         max_det=300, dtype=torch.bfloat16, data_parallel=True, device=device)
        images = serving_images(seed=11, count=MD_SERVE // 8)
        chunk = MD_CHUNK if mesh is not None else -(-MD_CHUNK // MD_RANKS) * MD_RANKS

        def dets(res):
            return [(np.array([d["class_id"] for d in r["detections"]]),
                     np.array([d["confidence"] for d in r["detections"]])) for r in res]

        zero_launches()
        deployed = dets(pred.predict_batch(images, batch_size=chunk))
        torch.cuda.synchronize()
        launches, phi = sq.spatial_quantize.launches, ml.phi_tiles.launches
        # cuDNN picks its algorithm by the batch, so one image rounds
        # differently in a 6- and a 12-image batch; PyTorch's own
        # convolution (im2col and a GEMM per image) does not
        torch.backends.cudnn.enabled = False
        try:
            per_image = dets(pred.predict_batch(images, batch_size=chunk))
        finally:
            torch.backends.cudnn.enabled = True
        return {"launches": launches, "phi_launches": phi, "dets": deployed,
                "dets_no_cudnn": per_image}

    timed_part("serving", serve)

    def evaluate():
        val = YOLODataset(inputs["val_dir"], IMG, 128, augment=False)
        batches = [{k: v for k, v in b.items() if k != "paths"}
                   for b in DataLoader(val, TRAIN_BATCH, shuffle=False, drop_last=False)]
        config = {"epochs": 3, "batch_size": TRAIN_BATCH, "seed": 0,
                  "output_dir": str(work / "eval"),
                  "model": {"name": "yolov8n", "num_classes": 80},
                  "data": {"img_size": IMG}, "morphology": {"downsample": 2},
                  "curriculum": {"enabled": False, "warmup_epochs": 0, "transition_epochs": 0},
                  "distillation": {"enabled": False}, "training": {"amp": False}}
        trainer = Trainer(config, batches[:1], batches, device=device)
        payload = load_checkpoint(inputs["eval_ckpt"])
        load_jax_variables(trainer.model, {c: payload[c] for c in COLLECTIONS if c in payload})
        if mesh is None:  # the labels: the one-rank program's confident detections
            _md_label(trainer, batches, inputs["val_labels"])
        with np.load(inputs["val_labels"]) as labels:
            for i, b in enumerate(batches):
                b.update({k: labels[k][i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for k in labels})
        zero_launches()
        res = trainer.evaluate(2)  # Stage 3: quantized
        torch.cuda.synchronize()
        return {"result": res, "launches": sq.spatial_quantize.launches,
                "phi_launches": ml.phi_tiles.launches, "forwards": len(batches)}

    # without cuDNN, as serving's check: its algorithm follows the batch (16
    # images in one rank, 8 in each of two), PyTorch's own convolution does not
    with torch.backends.cudnn.flags(enabled=False):
        timed_part("evaluate", evaluate)
    out["wall_s"] = wall
    return out


def _md_label(trainer, batches, path: str, conf: float = 0.25) -> None:
    """Label the val images with the one-rank eval program's detections of
    score >= conf at Stage 3 (as tests/test_torch_trainer_loop.py does), so
    that evaluate's mAP is far from 0 and moves with every detection."""
    import numpy as np
    import torch

    images = torch.as_tensor(np.concatenate([b["image"] for b in batches])).to(trainer.device)
    temp = trainer.curriculum.get_effective_temperature(2)
    boxes, scores, classes, valid, _ = (t.cpu().numpy() for t in trainer.eval_step(images, temp))
    n, slots = len(images), batches[0]["gt_boxes"].shape[1]
    gt = {"gt_boxes": np.zeros((n, slots, 4), np.float32),
          "gt_classes": np.zeros((n, slots), np.int32), "gt_mask": np.zeros((n, slots), bool)}
    for i in range(n):
        keep = np.flatnonzero(valid[i] & (scores[i] >= conf))[:slots]
        gt["gt_boxes"][i, :len(keep)] = boxes[i][keep]
        gt["gt_classes"][i, :len(keep)] = classes[i][keep]
        gt["gt_mask"][i, :len(keep)] = True
    np.savez(path, **gt)


def _md_rank_main(work: str, rank: int, inputs: dict) -> None:
    """One rank of phase 10 (a spawned process): joins the gloo group
    through a file store in `work`, runs the parts, writes rank{r}.pkl."""
    import datetime
    import faulthandler
    import pickle

    import torch
    import torch.distributed as dist

    faulthandler.enable()  # a native crash prints the Python stack
    sys.path.insert(0, str(ROOT))
    from mcaq_yolo_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                            world_size=MD_RANKS, timeout=datetime.timedelta(seconds=300))
    try:
        out = _md_cases(Path(work), torch.device("cuda", 0), make_mesh(device_type="cuda"),
                        inputs)
    finally:
        dist.destroy_process_group()
    with open(Path(work) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def phase_multi_device(device, workdir: Path, gpu: str, inputs: dict) -> dict:
    """Two ranks sharing the card over gloo (NCCL refuses two ranks on one
    GPU) against the one-rank program on the same global batches: 'dp' and
    'fsdp' training, DP serving, distributed evaluate.  The kernels were
    built in phase 1; the spawned ranks load them."""
    import pickle

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    work = workdir / "multi_device"
    work.mkdir()
    inputs = dict(inputs, val_labels=str(work / "val_labels.npz"))
    t0 = time.perf_counter()
    one = _md_cases(work / "one", device, None, inputs)
    t_one = time.perf_counter() - t0
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_md_rank_main, args=(str(work), r, inputs))
             for r in range(MD_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    t_ranks = time.perf_counter() - t0
    check(all(p.exitcode == 0 for p in procs),
          f"multi-device ranks exited {[p.exitcode for p in procs]}")
    ranks = []
    for r in range(MD_RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    def stats_err(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def same_dets(x, y, exact):
        return all(np.array_equal(a[0], b[0]) and (
            np.array_equal(a[1], b[1]) if exact else
            np.allclose(a[1], b[1], rtol=MD_CONF_RTOL, atol=MD_CONF_ATOL))
            for a, b in zip(x, y))

    ref = one["dp"]
    training = {}
    for mode in ("dp", "fsdp"):
        got = ranks[0][mode]
        loss0 = (got["epochs"][0]["loss_total"], ref["epochs"][0]["loss_total"])
        training[mode] = {
            "first_loss": [round(v, 6) for v in loss0],
            "first_loss_rel": abs(loss0[0] - loss0[1]) / abs(loss0[1]),
            "losses": [round(e["loss_total"], 6) for e in got["epochs"]],
            "losses_one_rank": [round(e["loss_total"], 6) for e in ref["epochs"]],
            "param_rel_l2": rel_l2(got["params"], ref["params"]),
            "param_diff_over_step": float(np.linalg.norm(got["params"] - ref["params"])
                                          / np.linalg.norm(ref["params"] - ref["start"])),
            "bn_stats_rel": stats_err(got["stats"], ref["stats"]),
            "ranks_equal": bool(np.array_equal(ranks[1][mode]["params"], got["params"])),
            "placed_fraction": got["placed_fraction"], "rule_fraction": got["rule_fraction"],
        }
    serve_one, serve_two = one["serving"], ranks[0]["serving"]
    conf_close = same_dets(serve_two["dets_no_cudnn"], serve_one["dets_no_cudnn"], False)
    conf_bitwise = same_dets(serve_two["dets_no_cudnn"], serve_one["dets_no_cudnn"], True)
    cudnn_differ = sum(not same_dets([a], [b], False)
                       for a, b in zip(serve_two["dets"], serve_one["dets"]))
    forwards = -(-MD_SERVE // (-(-MD_CHUNK // MD_RANKS) * MD_RANKS))
    ev_one, ev_two = one["evaluate"], ranks[0]["evaluate"]
    emit({"phase": "multi_device", "gpu": gpu,
          "ranks": f"{MD_RANKS} ranks sharing one card over gloo",
          "training": training,
          "bounds": {"first_loss_rel": MD_LOSS_RTOL, "param_diff_over_step": MD_STEP_REL,
                     "bn_stats_rel": MD_STATS_RTOL,
                     "serving_confidence": [MD_CONF_RTOL, MD_CONF_ATOL]},
          "dp_serving": {"images": MD_SERVE, "batch_size": MD_CHUNK,
                         "forwards_per_rank": forwards,
                         "launches_per_rank": [r["serving"]["launches"] for r in ranks],
                         "phi_launches_per_rank": [r["serving"]["phi_launches"] for r in ranks],
                         "detections": sum(len(d[0]) for d in serve_two["dets"]),
                         "equal_within_bound_without_cudnn": conf_close,
                         "bitwise_without_cudnn": conf_bitwise,
                         "images_differing_with_cudnn": cudnn_differ},
          "dp_evaluate": {"one_rank": ev_one["result"], "two_ranks": ev_two["result"],
                          "forwards_per_rank": ev_two["forwards"],
                          "launches_per_rank": [r["evaluate"]["launches"] for r in ranks],
                          "phi_launches_per_rank": [r["evaluate"]["phi_launches"]
                                                    for r in ranks]},
          "wall_s": {"one_rank": round(t_one, 3), "ranks": round(t_ranks, 3),
                     "parts_one_rank": one["wall_s"], "parts_rank0": ranks[0]["wall_s"]}})
    for mode, t in training.items():
        check(t["first_loss_rel"] <= MD_LOSS_RTOL, f"{mode}: first loss {t['first_loss']}")
        check(t["param_diff_over_step"] <= MD_STEP_REL,
              f"{mode}: parameters {t['param_diff_over_step']:.3g} of the steps' movement")
        check(t["bn_stats_rel"] <= MD_STATS_RTOL, f"{mode}: BN statistics {t['bn_stats_rel']:.3g}")
        check(t["ranks_equal"], f"{mode}: the two ranks hold different parameters")
    check(training["fsdp"]["placed_fraction"] == training["fsdp"]["rule_fraction"] > 0.9,
          "fsdp placed another fraction than the rule's")
    check(training["dp"]["placed_fraction"] == 0.0, "dp placed a DTensor")
    check(all(same_dets(r["serving"]["dets"], serve_two["dets"], True) for r in ranks),
          "the ranks returned different lists")
    check(conf_close, "DP serving (per-image convolutions) differs from one rank: counts, "
                      "classes or confidences outside rtol 2e-5, atol 2e-6")
    check(all(r["serving"]["launches"] == 3 * forwards for r in ranks),
          f"DP serving launched {[r['serving']['launches'] for r in ranks]} times per rank "
          f"in {forwards} forwards (expected 3 each)")
    check(ev_one["result"]["map50"] > 0.2, f"the labelled evaluate is not informative: {ev_one}")
    check(all(ev_two["result"][k] == ev_one["result"][k] for k in ("map50", "map50_95"))
          and abs(ev_two["result"]["avg_bits"] - ev_one["result"]["avg_bits"])
          <= 1e-6 * ev_one["result"]["avg_bits"],  # a mean of the ranks' means
          "distributed evaluate differs from one rank")
    check(all(r["evaluate"]["launches"] == 3 * ev_two["forwards"] for r in ranks),
          "distributed evaluate's launches are not 3 per forward per rank")
    check(all(r["serving"]["phi_launches"] == 3 * forwards
              and r["evaluate"]["phi_launches"] == 3 * ev_two["forwards"] for r in ranks),
          "the ranks' phi launches are not 3 per forward")
    PHI_LAUNCHES["dp_serving"] = serve_two["phi_launches"]
    PHI_LAUNCHES["dp_evaluate"] = ev_two["phi_launches"]
    return {"dp_serving": serve_two["launches"], "dp_evaluate": ev_two["launches"]}


# ---------------------------------------------------------------------------
# Phase 11
# ---------------------------------------------------------------------------

DRYRUN_RANKS = 2    # dryrun_multichip's ranks here: they share the one card over gloo
ENTRY_REPS = 5      # timed calls of entry()'s fn per input


def _entry_call(model, fn, x, name: str) -> dict:
    """fn(model, x) through the kernels and through the quantizer's plain
    version: 3 spatial_quant and 3 phi_tiles launches in the first, none of
    spatial_quant in the second, raw maps bitwise equal, outputs finite;
    then the kernel call timed (host clock around synchronised calls)."""
    import torch

    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq

    zero_launches()
    raw, avg_bits = fn(model, x)
    torch.cuda.synchronize()
    launches = {"spatial_quant": sq.spatial_quantize.launches,
                "phi_tiles": ml.phi_tiles.launches}
    model.set_quant_backend("torch")
    try:
        zero_launches()
        raw_p, avg_p = fn(model, x)
        torch.cuda.synchronize()
        plain = sq.spatial_quantize.launches
    finally:
        model.set_quant_backend("auto")
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(raw, raw_p)) and torch.equal(avg_bits, avg_p)
    finite = all(bool(torch.isfinite(a).all()) for a in raw) and bool(torch.isfinite(avg_bits))
    times = []
    for _ in range(ENTRY_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(model, x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    check(launches == {"spatial_quant": 3, "phi_tiles": 3},
          f"entry fn on {name}: launches {launches} (expected 3 of each a call)")
    check(plain == 0, f"entry fn on {name}: the plain path launched spatial_quant {plain} times")
    check(same, f"entry fn on {name}: raw maps differ between the kernel and the plain path")
    check(finite, f"entry fn on {name}: non-finite output")
    return {"launches": launches, "plain_launches": plain, "raw_maps_bitwise_equal": same,
            "finite": finite, "avg_bits": float(avg_bits),
            "shapes": [list(a.shape) for a in raw], "ms": sorted(times)[len(times) // 2]}


def phase_entry_and_example(device, workdir: Path, gpu: str) -> dict:
    """Phase 11: the entry points (`mcaq_yolo_tpu_torch/entry.py`): entry()'s
    fn on its zero images and on letterboxed serving images; the 2-rank
    dryrun (the ranks share the card over gloo), each program's launches
    per rank; the train example end to end, its Trainer.train and
    Predictor.predict each counted.  Temporary files go under `workdir`."""
    import importlib.util
    import tempfile as tf

    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch import entry as port_entry
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.data.dataset import letterbox
    from mcaq_yolo_tpu_torch.inference import Predictor
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq
    from mcaq_yolo_tpu_torch.train import Trainer

    wall = {}
    t0 = time.perf_counter()
    fn, (model, zeros) = port_entry.entry(device)
    check(tuple(zeros.shape) == (4, 3, IMG, IMG) and zeros.device.type == device.type
          and zeros.is_contiguous(memory_format=torch.channels_last),
          f"entry's images: {tuple(zeros.shape)} on {zeros.device}")
    served = np.stack([letterbox(im, IMG)[0] for im in serving_images(seed=5, count=1)[:4]])
    served = torch.from_numpy(served).to(device).float().div(255.0).permute(0, 3, 1, 2)
    calls = {"zeros": _entry_call(model, fn, zeros, "zeros"),
             "serving_images": _entry_call(model, fn, served, "serving images")}
    del model
    wall["entry"] = round(time.perf_counter() - t0, 3)

    before = tf.tempdir
    tf.tempdir = str(workdir)  # the dryrun's store and the example's dataset
    try:
        t0 = time.perf_counter()
        dry = port_entry.dryrun_multichip(DRYRUN_RANKS, device=device)
        wall["dryrun"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        dry_cpu = port_entry.dryrun_multichip(DRYRUN_RANKS, device="cpu")
        wall["dryrun_cpu"] = round(time.perf_counter() - t0, 3)

        counts = {}

        def counted(name, method):
            def run(*args, **kwargs):
                zero_launches()
                out = method(*args, **kwargs)
                torch.cuda.synchronize()
                counts[name] = {"spatial_quant": sq.spatial_quantize.launches,
                                "phi_tiles": ml.phi_tiles.launches}
                return out
            return run

        spec = importlib.util.spec_from_file_location(
            "train_example_torch", ROOT / "examples" / "train_example_torch.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        train, predict = Trainer.train, Predictor.predict
        Trainer.train = counted("train", train)
        Predictor.predict = counted("serve", predict)
        try:
            t0 = time.perf_counter()
            ex = example.main([] if device.type == "cuda" else ["--device", "cpu"])
            wall["example"] = round(time.perf_counter() - t0, 3)
        finally:
            Trainer.train, Predictor.predict = train, predict
    finally:
        tf.tempdir = before

    # the card's ranks against the CPU's on the same seeded weights and batch
    # (TF32 off, as in phase 5's step): the first program's loss and bits
    # within phase 5's 1e-3; the later programs start from weights the first
    # step moved, so they are printed, not bounded
    dry_rel = {k: abs(dry["dp"][k] - dry_cpu["dp"][k]) / abs(dry_cpu["dp"][k])
               for k in ("loss", "avg_bits")}
    expected = {"dp": {"spatial_quant": 0, "phi_tiles": 3},
                "serving": {"spatial_quant": 3, "phi_tiles": 3},
                "fsdp": {"spatial_quant": 0, "phi_tiles": 3}}
    res = ex["inference"]
    emit({"phase": "entry_and_example", "gpu": gpu, "entry": calls,
          "dryrun": {"ranks": DRYRUN_RANKS, "dp": dry["dp"], "serving": dry["serving"],
                     "fsdp": dry["fsdp"], "launches_per_rank": dry["launches_per_rank"],
                     "cpu_ranks": {k: dry_cpu[k] for k in ("dp", "serving", "fsdp")},
                     "dp_rel_err_vs_cpu": dry_rel, "tolerance": "DP step 1e-3 relative"},
          "example": {"launches": counts, "epochs": len(ex["history"]),
                      "best_map50": ex["results"]["best_map50"],
                      "avg_bits": res["avg_bits"], "detections": len(res["detections"]),
                      "history_avg_bits": [round(h.get("avg_bits", float("nan")), 4)
                                           for h in ex["history"]]},
          "wall_s": wall})
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must be off for the dryrun's card-versus-CPU check")
    check(max(dry_rel.values()) <= 1e-3, f"the dryrun's DP step on the card differs from "
                                         f"the CPU's: {dry_rel}")
    check(all(r == expected for r in dry["launches_per_rank"]),
          f"dryrun launches per rank {dry['launches_per_rank']} (expected {expected})")
    check(ex["checkpoint"].is_file() and len(ex["history"]) == 3,
          "the example wrote no last.ckpt or not 3 epochs of history")
    check(2.0 <= res["avg_bits"] <= 8.0 and all(
        np.isfinite(d["bbox"]).all() and np.isfinite(d["confidence"])
        for d in res["detections"]), f"the example's result: avg_bits {res['avg_bits']}")
    check(counts.get("serve") == {"spatial_quant": 3, "phi_tiles": 3},
          f"the example's Predictor.predict launched {counts.get('serve')} (expected 3 + 3)")
    check(counts["train"]["spatial_quant"] > 0 and counts["train"]["phi_tiles"] > 0,
          f"the example's training launched {counts['train']}")

    def total(kernel, *parts):
        return sum(p[kernel] for p in parts)

    entry_parts = [c["launches"] for c in calls.values()]
    dry_parts = list(dry["launches"].values())
    example_parts = list(counts.values())
    PHI_LAUNCHES["entry"] = total("phi_tiles", *entry_parts)
    PHI_LAUNCHES["dryrun"] = total("phi_tiles", *dry_parts)
    PHI_LAUNCHES["example"] = total("phi_tiles", *example_parts)
    return {"entry": total("spatial_quant", *entry_parts),
            "dryrun": total("spatial_quant", *dry_parts),
            "example": total("spatial_quant", *example_parts)}


# ---------------------------------------------------------------------------
# Phase 12
# ---------------------------------------------------------------------------

# a short budget and few iterations: the gates still pass every arm (each
# needs its estimate + 20 s left), and the phase takes about a minute
BENCH_ENV = {"BENCH_TIME_BUDGET_S": "180", "BENCH_ITERS": "8"}
BENCH_RECORD = ROOT / "evidence" / "torch" / "bench_last.json"
BENCH_METRIC = "yolov8n_mcaq_e2e_infer_640_images_per_sec_per_chip"
# arm -> (spatial_quant, phi_tiles) launches per call of its program
BENCH_LAUNCHES = {"headline": (3, 3), "e2e_bs128_ds2": (3, 3), "e2e_bs256_ds1": (3, 3),
                  "fwd_bs256_ds2": (3, 3), "plain_bs32": (0, 3),
                  "train_yolov8m_bs32": (0, 3)}
BENCH_RUNS_KEYS = ("e2e_decode_nms_sweep_imgs_per_sec_runs", "fwd_only_imgs_per_sec_runs",
                   "infer_torch_backend_imgs_per_sec_runs",
                   "train_yolov8m_bs32_imgs_per_sec_per_chip_runs")


def phase_bench(gpu: str) -> dict:
    """Phase 12: `python -m mcaq_yolo_tpu_torch.bench` in a process group of
    its own, as a user runs it (with BENCH_ENV): rc 0, the headline line
    first, bench.py's keys and metric name on the last line, every arm but
    torch_cpu_fallback measured, the card named, 3 + 3 launches per forward
    of the headline program (and each arm's expected launches), a positive
    headline.  The record it writes is checked against its last line, then
    the committed `evidence/torch/bench_last.json` is put back."""
    import os
    import signal

    import torch

    torch.cuda.empty_cache()  # leave the card's memory to the bench's process
    committed = BENCH_RECORD.read_bytes() if BENCH_RECORD.exists() else None
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_ENV)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "mcaq_yolo_tpu_torch.bench"], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=float(BENCH_ENV["BENCH_TIME_BUDGET_S"]) + 240)
        written = BENCH_RECORD.read_text() if BENCH_RECORD.exists() else ""
    finally:
        if proc.poll() is None:  # the wrapper and its child: the whole group
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        if committed is not None:
            BENCH_RECORD.write_bytes(committed)
    wall = round(time.perf_counter() - t0, 3)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    check(proc.returncode == 0 and lines, f"the bench exited {proc.returncode}: "
                                          f"{(out + err)[-2000:]}")
    first, last = json.loads(lines[0]), json.loads(lines[-1])
    ex = last.get("extra", {})
    emit({"phase": "bench", "gpu": gpu, "env": BENCH_ENV, "lines": len(lines),
          "first_line_value": first.get("value"), "record": last, "wall_s": wall})
    check(all(k in last for k in ("metric", "value", "unit", "vs_baseline", "extra")),
          f"the bench's last line lacks bench.py's keys: {sorted(last)}")
    check(last["metric"] == BENCH_METRIC and first.get("metric") == BENCH_METRIC,
          f"the bench's metric {last['metric']!r} (expected {BENCH_METRIC!r})")
    check(first.get("value", 0) > 0 and "headline_config" in first.get("extra", {}),
          "the bench's first line is not the headline")
    check(last["vs_baseline"] == round(last["value"] / 151.0, 3),
          f"vs_baseline {last['vs_baseline']} for value {last['value']}")
    check(json.loads(written or "{}") == last,
          "evidence/torch/bench_last.json is not the bench's last line")
    missing = [a for a in BENCH_LAUNCHES if a != "headline" and
               (a in ex.get("arm_errors", {}) or a in last["extra"]["skipped_arms"])]
    check(not missing, f"bench arms not measured: {missing}: {ex.get('arm_errors')} "
                       f"{ex.get('skip_reasons')}")
    check("torch_cpu_fallback" in ex.get("skip_reasons", {})
          or "torch_cpu_fallback_imgs_per_sec" in ex,
          "torch_cpu_fallback neither measured nor skipped with a reason")
    check(ex.get("device", {}).get("device") == torch.cuda.get_device_name(0)
          and ex["device"].get("nvidia_smi") == gpu,
          f"the bench's device stamp {ex.get('device')} (expected {gpu})")
    for arm, (sq_n, phi_n) in BENCH_LAUNCHES.items():
        got = ex["launches"].get(arm, {})
        check(got.get("spatial_quant") == sq_n and got.get("phi_tiles") == phi_n,
              f"bench {arm}: launches per call {got} (expected {sq_n} + {phi_n})")
        check(arm in ex.get("peak_mem_GB", {}), f"bench {arm}: no peak memory")
    runs = [r for key in BENCH_RUNS_KEYS for r in (
        ex[key].values() if isinstance(ex.get(key), dict) else [ex.get(key, [])])]
    check(len(runs) == len(BENCH_LAUNCHES) and all(len(r) == 5 for r in runs),
          f"the bench's runs: {runs} (expected 5 for each of {len(BENCH_LAUNCHES)} "
          "measurements)")

    def total(kernel):
        return int(round(sum(v[kernel] * v["calls"] for v in ex["launches"].values())))

    PHI_LAUNCHES["bench"] = total("phi_tiles")
    return {"bench": total("spatial_quant")}


def _numbers(tree, skip=("spearman_rho", "spearman_p", "quartiles")):
    """The numbers of a result tree, without M4's rank test and quartile
    CIs (undefined, NaN, when every per-image gain is equal)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if k in skip:
            continue
        if isinstance(v, (dict, list)):
            yield from _numbers(v, skip)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield float(v)


def phi_kernel_entry(phi_rows, worst: float) -> dict:
    """The phi kernel's entry of the `kernels` line: its times summed over the
    three scales of one bs-32 forward, the bound of that work, and its
    launches on every path (the deployed one as `launches`)."""
    from mcaq_yolo_tpu_torch.utils.cuda_timing import bound_ms

    bs32 = [r for r in phi_rows if r["cell"] == "serving" and r["batch"] == 32]
    bound, by = bound_ms(sum(r["bytes"] for r in bs32), sum(r["ops"] for r in bs32))
    check(PHI_LAUNCHES.get("deployed", 0) > 0, "the main path never launched the phi kernel")
    return {"name": "phi_tiles", "route": "cuda", "source": PHI_SOURCE,
            "replaces": PHI_REPLACES, "launches": PHI_LAUNCHES["deployed"],
            "max_abs_err": worst, "ms": sum(r["ms"] for r in bs32),
            "plain_ms": sum(r["plain_ms"] for r in bs32), "bound_ms": bound, "bound_by": by,
            "library_ms": None, "launches_by_path": dict(PHI_LAUNCHES)}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sources = (KERNEL_SOURCE, PHI_SOURCE, BN_SILU_SOURCE, FRAC_QUANT_SOURCE, CONV_F32_SOURCE)
    if not all((ROOT / src).is_file() for src in sources):
        print(f"chip_smoke: one of {', '.join(sources)} not found; run from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda")
    dtype = torch.bfloat16

    wall = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        wall[name] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()

    gpu = phase_environment()
    lap("1_environment")
    worst = phase_kernel_vs_plain(device)
    rtdetr_tap_timings(device)
    lap("2_kernel_vs_plain")
    phi_worst = phase_phi_vs_plain(device)
    lap("2b_phi_vs_plain")
    bn_rows = phase_bn_silu(device)
    lap("2c_bn_silu")
    fq_rows = phase_frac_quant(device)
    lap("2d_frac_quant")
    cf_row = phase_conv_f32(device)
    lap("2e_conv_f32")
    scratch = ROOT / "build"  # gitignored; the run writes nothing outside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        pred, launches = phase_deployed_program(device, dtype, Path(tmp))
        lap("3_deployed_program")
        path_launches = {}
        for variant, (path, _, _) in FAMILY_CALLS.items():
            path_launches[path] = phase_family_deployed(device, dtype, Path(tmp), variant)
            lap(f"3_{path}")
        rows, phi_rows = phase_timings(pred, device, dtype)
        del pred
        lap("4_timings")
        path_launches.update(phase_training(device, Path(tmp)))
        phase_step_cuda_vs_cpu(device)
        lap("5_training")
        path_launches.update(phase_train_from_disk(device, Path(tmp), gpu))
        lap("6_train_from_disk")
        sd = phase_convert(device, gpu)
        path_launches.update(phase_deploy(device, Path(tmp), gpu, sd, Path(tmp) / "ds"))
        lap("7_deploy")
        path_launches.update(phase_evidence_scripts(device, Path(tmp), gpu))
        lap("8_evidence_scripts")
        path_launches.update(phase_diagnostics(device, gpu, Path(tmp)))
        lap("9_diagnostics")
        path_launches.update(phase_multi_device(device, Path(tmp), gpu, {
            "serve_ckpt": str(Path(tmp) / "mcaq_yolov8n.ckpt"),
            "teacher": str(Path(tmp) / "teacher.msgpack"),
            "eval_ckpt": str(Path(tmp) / "mcaq_yolov8n.ckpt"),
            "val_dir": str(Path(tmp) / "ds" / "images" / "val")}))
        lap("10_multi_device")
        path_launches.update(phase_entry_and_example(device, Path(tmp), gpu))
        lap("11_entry_and_example")
    path_launches.update(phase_bench(gpu))
    lap("12_bench")
    emit({"phase": "wall_s", "gpu": gpu, **wall, "total": round(sum(wall.values()), 3)})

    emit({"kernels": [{
        "name": "spatial_quant", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
        "library_ms": None,
        "launches_by_path": dict(deployed=launches, **path_launches),
    }, phi_kernel_entry(phi_rows, phi_worst), bn_silu_kernel_entry(bn_rows),
        frac_quant_kernel_entry(fq_rows), conv_f32_kernel_entry(cf_row)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
