"""
Predictor and its command line (port of `mcaq_yolo_tpu/inference.py`).

Loads a flax msgpack checkpoint and its `.json` meta, letterboxes inputs on
the host, runs forward (quantization on, deploy temperature) + decode +
NMS on the device, and inverts the letterbox.  Results follow the
reference's contract: detections, inference_time_ms, avg_bits and the
P3-scale complexity / bit maps.

    python -m mcaq_yolo_tpu_torch.inference --model ckpt --source DIR_OR_IMAGE \
        [--output out.json] [--visualize --output-dir DIR] [--device cpu]

runs on CUDA unless `--device` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .data.dataset import IMG_EXTS, letterbox, read_image, unletterbox_boxes
from .device import DeviceLike, resolve_device
from .models.mcaq_yolo import MCAQYOLO
from .models.yolo import decode_and_nms
from .utils.checkpoint import load_meta
from .utils.model_utils import restore_into


def auto_pre_topk(max_det: int, conf_threshold: float = 0.25) -> int:
    """NMS candidate-pool size: 256 for deployed gates (conf >= 0.25), 512
    for low-confidence eval gates.  The pool only has to cover the
    above-gate candidates; saturation is reported at run time."""
    del max_det
    return 256 if conf_threshold >= 0.25 else 512


def deployed_program(model: MCAQYOLO, images: torch.Tensor, num_classes: int,
                     conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                     max_det: int = 1000, pre_topk: Optional[int] = None,
                     temperature: float = 1.0):
    """The deployed program: the quantized forward at `temperature`, then
    decode + NMS, on (B, S, S, 3) uint8 -> (boxes, scores, classes, valid,
    avg_bits, the P3 complexity map, the P3 bit map, the above-gate
    candidate count per image).  `pre_topk` None: `auto_pre_topk`."""
    if pre_topk is None:
        pre_topk = auto_pre_topk(max_det, conf_threshold)
    raw, aux = model(images, temperature=temperature, quantize=True)
    *det, gated_count = decode_and_nms(
        raw, num_classes, conf_threshold=conf_threshold, iou_threshold=iou_threshold,
        max_det=max_det, pre_topk=pre_topk, with_pool_stats=True)
    return tuple(det) + (aux["avg_bits"], aux["complexity_map"][0], aux["bit_map"][0],
                         gated_count)


class Predictor:
    """Single-image / batch MCAQ-YOLO inference on one device.

    `dtype` is the network compute dtype (torch.bfloat16 for the deployed
    program); `device` defaults to CUDA and raises without one.  Like the
    reference's, it takes no calibration mode: it builds a 'minmax' model
    and serves the checkpoint's frozen EMA statistics whatever mode
    calibrated them (an entropy-mode histogram in the checkpoint is left
    out).  `data_parallel` (the reference's batch split over devices) and
    `morph_tile_engine` (default: the meta's `morphology.tile_engine`) are
    accepted; the port serves on the one device."""

    def __init__(self, model_path: str, num_classes: int = 80, variant: str = "yolov8n",
                 img_size: Optional[int] = None, conf_threshold: float = 0.25,
                 iou_threshold: float = 0.45, max_det: int = 1000,
                 pre_topk: Optional[int] = None, class_names: Optional[Dict[int, str]] = None,
                 bit_mapping: str = "mlp", grid_size: int = 8, warmup: bool = True,
                 min_bits: Optional[int] = None, max_bits: Optional[int] = None,
                 monotone_param: Optional[str] = None,
                 normalize_complexity: Optional[bool] = None,
                 morph_downsample: Optional[int] = None, data_parallel: bool = False,
                 morph_tile_engine: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        self.device = resolve_device(device)
        if data_parallel and self.device.type == "cuda" and torch.cuda.device_count() > 1:
            print(f"[MCAQ] data_parallel: serving on {self.device} only "
                  f"({torch.cuda.device_count()} devices visible)")
        # every model-defining training key comes from the meta; explicit
        # kwargs win (None = from meta, then the default)
        meta = load_meta(model_path)
        variant = meta.get("variant", variant)
        num_classes = int(meta.get("num_classes", num_classes))
        cfg = meta.get("config", {})
        qcfg = cfg.get("quantization", {})
        morph = cfg.get("morphology", {})
        bit_mapping = qcfg.get("bit_mapping", bit_mapping)
        grid_size = int(qcfg.get("grid_size", grid_size))
        if img_size is None:
            img_size = int(meta.get("img_size", 640))

        def auto(explicit, meta_val, default, cast):
            if explicit is not None:
                return cast(explicit)
            return cast(meta_val) if meta_val is not None else default

        min_bits = auto(min_bits, qcfg.get("min_bits"), 2, int)
        max_bits = auto(max_bits, qcfg.get("max_bits"), 8, int)
        target_bits = float(qcfg.get("target_bits", 4.0))
        # meta-less checkpoints predate the softplus default: 'abs'
        monotone_param = auto(monotone_param, qcfg.get("monotone_param"), "abs", str)
        normalize_complexity = auto(normalize_complexity,
                                    qcfg.get("normalize_complexity"), False, bool)
        morph_downsample = auto(morph_downsample, morph.get("downsample"), 1, int)
        morph_tile_engine = auto(morph_tile_engine, morph.get("tile_engine"), "lanes", str)
        self.deploy_temperature = float(meta.get("deploy_temperature", 1.0))

        self.img_size = img_size
        self.num_classes = num_classes
        self.conf_threshold = conf_threshold
        self.iou_threshold = iou_threshold
        self.max_det = max_det
        self.pre_topk = (int(pre_topk) if pre_topk is not None
                         else auto_pre_topk(max_det, conf_threshold))
        self.pool_saturations = 0
        names = meta.get("names")
        if names:
            names = {int(k): v for k, v in names.items()}
        self.class_names = class_names or names or {
            i: f"class{i}" for i in range(num_classes)}

        self.model = MCAQYOLO(
            variant=variant, num_classes=num_classes, bit_mapping=bit_mapping,
            grid_size=grid_size, min_bits=min_bits, max_bits=max_bits,
            target_bits=target_bits, monotone_param=monotone_param,
            normalize_complexity=normalize_complexity,
            morph_downsample=morph_downsample, morph_tile_engine=morph_tile_engine,
            dtype=dtype, device=self.device)
        restore_into(self.model, model_path)
        if warmup:
            self._warmup()

    def _warmup(self, iters: int = 2):
        x = torch.zeros((1, self.img_size, self.img_size, 3), dtype=torch.uint8,
                        device=self.device)
        for _ in range(iters):
            self._predict_device(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _predict_device(self, images: torch.Tensor):
        """The deployed program (`deployed_program`) at this Predictor's
        gate, pool and deploy temperature."""
        return deployed_program(self.model, images, self.num_classes, self.conf_threshold,
                                self.iou_threshold, self.max_det, self.pre_topk,
                                self.deploy_temperature)

    def _check_pool_headroom(self, gated_count: np.ndarray) -> None:
        """Warn (every time) when the above-gate candidates fill the pool."""
        worst = int(np.max(gated_count))
        if worst >= self.pre_topk:
            self.pool_saturations += 1
            with warnings.catch_warnings():
                warnings.simplefilter("always", RuntimeWarning)
                warnings.warn(
                    f"NMS candidate pool saturated ({self.pool_saturations} time(s) this "
                    f"Predictor): {worst} above-gate candidates hit pre_topk="
                    f"{self.pre_topk}; detections may have been cut before suppression. "
                    "Re-run with a larger pre_topk (e.g. 1024) for this data "
                    "distribution.", RuntimeWarning, stacklevel=3)

    def preprocess(self, image: np.ndarray):
        """Letterbox, keeping uint8 (the /255 runs on the device)."""
        lb, scale, pad = letterbox(image, self.img_size)
        return np.ascontiguousarray(lb, np.uint8), scale, pad

    def _run(self, stack: np.ndarray):
        t0 = time.perf_counter()
        out = self._predict_device(torch.from_numpy(stack).to(self.device))
        out = [o.cpu().numpy() for o in out]
        return out, (time.perf_counter() - t0) * 1000.0

    def _results(self, out, j, scale, pad, orig_hw, dt_ms) -> Dict:
        boxes, scores, classes, valid, avg_bits, cmap, bmap, _ = out
        v = valid[j].astype(bool)
        det_boxes = unletterbox_boxes(boxes[j][v], scale, pad, orig_hw)
        cls = classes[j][v]
        return {
            "detections": [
                {"bbox": det_boxes[m].tolist(), "confidence": float(scores[j][v][m]),
                 "class_id": int(cls[m]),
                 "class_name": self.class_names.get(int(cls[m]), str(int(cls[m])))}
                for m in range(int(v.sum()))],
            "inference_time_ms": dt_ms,
            "avg_bits": float(avg_bits),
            "complexity_map": np.asarray(cmap[j]),
            "bit_map": np.asarray(bmap[j]),
        }

    def predict(self, image: np.ndarray, visualize: bool = False,
                output_dir: Optional[str] = None) -> Dict:
        """image: HxWx3 uint8 RGB -> the reference's result contract; with
        `visualize` and `output_dir`, also writes complexity.png and
        bits.png there (matplotlib)."""
        img, scale, pad = self.preprocess(image)
        out, dt_ms = self._run(img[None])
        self._check_pool_headroom(out[-1])
        results = self._results(out, 0, scale, pad, image.shape[:2], dt_ms)
        if visualize and output_dir:
            from .utils import visualization as viz

            Path(output_dir).mkdir(parents=True, exist_ok=True)
            viz.visualize_complexity_map(image, results["complexity_map"],
                                         str(Path(output_dir) / "complexity.png"))
            viz.visualize_bit_allocation(image, results["bit_map"],
                                         str(Path(output_dir) / "bits.png"))
        return results

    def predict_batch(self, images: Sequence, batch_size: int = 16) -> List[Dict]:
        """Batched forwards over HxWx3 uint8 RGB images or image paths (read
        per chunk, so a large directory holds one chunk in memory); the
        ragged tail is padded by repeating the last image so every chunk has
        one shape."""
        n = len(images)
        if n == 0:
            return []
        batch_size = min(batch_size, n)
        results: List[Dict] = []
        for i in range(0, n, batch_size):
            raw = [im if isinstance(im, np.ndarray) else read_image(str(im))
                   for im in images[i:i + batch_size]]
            chunk = [self.preprocess(im) for im in raw]
            k = len(chunk)
            stack = np.stack([c[0] for c in chunk])
            if k < batch_size:
                stack = np.concatenate([stack, np.repeat(stack[-1:], batch_size - k, axis=0)])
            out, dt_ms = self._run(stack)
            self._check_pool_headroom(out[-1][:k])
            for j in range(k):
                _, scale, pad = chunk[j]
                results.append(self._results(out, j, scale, pad, raw[j].shape[:2], dt_ms / k))
        return results


# ---------------------------------------------------------------------------
# Command line (reference `inference.py:379-455`)
# ---------------------------------------------------------------------------


def main(argv=None):
    parser = argparse.ArgumentParser(description="MCAQ-YOLO inference (PyTorch)")
    parser.add_argument("--model", required=True, help="checkpoint path (.ckpt)")
    parser.add_argument("--source", required=True, help="image file or directory")
    parser.add_argument("--conf", type=float, default=0.25)
    parser.add_argument("--iou", type=float, default=0.45)
    parser.add_argument("--max-det", type=int, default=1000)
    parser.add_argument("--pre-topk", type=int, default=None,
                        help="NMS candidate-pool size (default: auto from the conf gate)")
    parser.add_argument("--img-size", type=int, default=640)
    parser.add_argument("--num-classes", type=int, default=80)
    parser.add_argument("--variant", default="yolov8n")
    parser.add_argument("--output", default=None, help="JSON dump path")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--output-dir", default="outputs/infer")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    predictor = Predictor(
        args.model, num_classes=args.num_classes, variant=args.variant,
        img_size=args.img_size, conf_threshold=args.conf, iou_threshold=args.iou,
        max_det=args.max_det, pre_topk=args.pre_topk, device=args.device)

    src = Path(args.source)
    if src.is_dir():
        files = sorted(str(p) for p in src.rglob("*") if p.suffix.lower() in IMG_EXTS)
        batch_results = predictor.predict_batch(files)  # paths: read per chunk
        all_results = {}
        for f, r in zip(files, batch_results):
            all_results[f] = {"num_detections": len(r["detections"]),
                              "inference_time_ms": r["inference_time_ms"],
                              "avg_bits": r["avg_bits"]}
            print(f"{f}: {len(r['detections'])} dets, {r['inference_time_ms']:.1f} ms, "
                  f"{r['avg_bits']:.2f} bits")
        summary = {
            "num_images": len(files),
            "mean_time_ms": float(np.mean([r["inference_time_ms"]
                                           for r in all_results.values()]))
            if all_results else 0.0,
            "results": all_results,
        }
        if args.output:
            Path(args.output).write_text(json.dumps(summary, indent=2))
        print(json.dumps({k: v for k, v in summary.items() if k != "results"}))
    else:
        r = predictor.predict(read_image(str(src)), visualize=args.visualize,
                              output_dir=args.output_dir)
        dump = {"detections": r["detections"], "inference_time_ms": r["inference_time_ms"],
                "avg_bits": r["avg_bits"]}
        if args.output:
            Path(args.output).write_text(json.dumps(dump, indent=2))
        print(json.dumps(dump, indent=2))


if __name__ == "__main__":
    main()
