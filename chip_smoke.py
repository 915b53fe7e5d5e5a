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
     soft mask, plus one non-multiple tile shape — bitwise equality;
  3. the deployed program: a seeded random MCAQ-YOLOv8n (nc=80, MLP bit
     mapper, softplus) written as a flax msgpack checkpoint + meta, served
     by `Predictor(model_path)` at 640 px in bfloat16 (pool 256, conf 0.25,
     IoU 0.45, max_det 300) over three batches of 8 letterboxed images;
     kernel launch counts are reset just before and read just after, and
     one forward with quant_backend='torch' must give bitwise-equal raw
     maps;
  4. timings with CUDA events (median of 21): the device time of the
     kernel, its plain version and the per-channel min/max pass, and the
     kernel's bound, per scale at bs=32 bf16 (8 launches back to back on
     distinct copies of the input, a working set larger than L2, queued
     behind a device sleep so the host's enqueue time is not counted),
     plus the kernel's host-paced time and host time per call; the
     deployed program's images/s at bs=32 and bs=256 (host included, as a
     caller sees it); the morphology stage's share of a forward.

Output: JSON lines; before the last, the `{"kernels": [...]}` summary; the
last line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside the repository, it exits 2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "mcaq_yolo_tpu_torch/csrc/spatial_quant.cu"
REPLACES = "mcaq_yolo_tpu/ops/pallas_quant.py:247"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM FP32 outside the tensor cores
# per element: divide, add, rint, 2 clamps, subtract, multiply, mask multiply
QUANT_OPS_PER_ELEMENT = 8
SCALES = (("P3", 80, 64, 10), ("P4", 40, 128, 10), ("P5", 20, 256, 5))
COPIES = 8
# ~10 ms at the H100's clocks: longer than the host needs to queue one
# timed round of launches
SLEEP_CYCLES = 20_000_000
IMG = 640


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 21, inner: int = 1, warmup: int = 3,
            device_only: bool = False, quartiles: bool = False):
    """Median over `reps` of the time per call of fn(k), k = 0 .. inner-1
    called back to back between two CUDA events; with `quartiles`, the
    (25th, 50th, 75th) percentiles instead.

    device_only: the calls are queued behind a device-side sleep issued
    before the first event, so the card runs them without waiting on the
    host between launches and the events measure device time alone.
    Otherwise the host's enqueue time counts, as it does for a caller."""
    import torch

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
    if quartiles:
        return tuple(statistics.quantiles(times, n=4))
    return statistics.median(times)


def host_us_per_call(fn, calls: int = 64) -> float:
    """Host time per call of fn(k) (enqueue only, no synchronise), in µs."""
    import torch

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


def quant_bound_ms(x, bit_map, mask) -> float:
    t_bytes = quant_bytes(x, bit_map, mask) / HBM_BYTES_PER_S
    t_ops = x.numel() * QUANT_OPS_PER_ELEMENT / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3


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


def phase_kernel_vs_plain(device) -> float:
    import torch

    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq

    g = torch.Generator(device=device).manual_seed(0)
    cases = [(name, 32, h, h, c, t, t) for name, h, c, t in SCALES]
    cases.append(("non-multiple", 4, 12, 12, 24, 5, 5))
    worst = 0.0
    for name, B, H, W, C, Ht, Wt in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for with_mask in (False, True):
                x = torch.randn((B, H, W, C), generator=g, device=device).to(dtype)
                # continuous bit maps exercise the in-kernel round and clip
                bits = torch.rand((B, Ht, Wt), generator=g, device=device) * 7.0 + 1.5
                lo, hi = torch.aminmax(x.reshape(-1, C), dim=0)
                lo, hi = lo.float().contiguous(), hi.float().contiguous()
                mask = (torch.rand((B, H, W), generator=g, device=device)
                        if with_mask else None)
                a = sq.spatial_quantize(x, bits, lo, hi, mask)
                b = sq.spatial_quantize_torch(x, bits, lo, hi, mask)
                torch.cuda.synchronize()
                ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                mism = int((a.view(ibits) != b.view(ibits)).sum())
                err = float((a.float() - b.float()).abs().max())
                worst = max(worst, err)
                emit({"phase": "kernel_vs_plain", "kernel": "spatial_quant", "case": name,
                      "shape": [B, H, W, C], "tiles": [Ht, Wt], "dtype": str(dtype),
                      "mask": with_mask, "mismatches": mism, "max_abs_err": err,
                      "tolerance": "bitwise"})
                check(mism == 0, f"spatial_quant differs from its plain version: {name} "
                                 f"{dtype} mask={with_mask}: {mism} elements")
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

    # the kernel path against the plain path through the whole network
    stack = np.stack([pred.preprocess(im)[0] for im in images[:8]])
    x = torch.from_numpy(stack).to(device)
    with torch.inference_mode():
        raw_k, _ = pred.model(x)
        pred.model.set_quant_backend("torch")
        raw_p, _ = pred.model(x)
        pred.model.set_quant_backend("auto")
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(raw_k, raw_p))
    finite = all(bool(torch.isfinite(a).all()) for a in raw_k)
    emit({"phase": "backend_parity", "raw_maps_bitwise_equal": same, "finite": finite,
          "shapes": [list(a.shape) for a in raw_k]})
    check(same and finite, "raw maps differ between quant_backend 'auto' and 'torch'")
    return pred, launches


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------


def phase_timings(pred, device, dtype):
    import numpy as np
    import torch

    from mcaq_yolo_tpu_torch.models.yolo import images_to_nchw
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq

    torch.backends.cudnn.deterministic = False
    model = pred.model
    rng = np.random.default_rng(2)
    x32 = torch.from_numpy(rng.integers(0, 256, (32, IMG, IMG, 3), dtype=np.uint8)).to(device)

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
                "ms_host_paced": cuda_ms(kernel, inner=COPIES),
                "host_us_per_call": host_us_per_call(kernel),
                "timing": f"device time of {COPIES} back-to-back launches on distinct "
                          "inputs queued behind a device sleep, median of 21; "
                          "ms_host_paced: the same without the sleep",
            }
            row["achieved_GBps"] = row["bytes"] / (row["ms"] * 1e-3) / 1e9
            row["bound_share"] = row["bound_ms"] / row["ms"]
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

    emit({"kernels": [{
        "name": "spatial_quant", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "bytes",
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
