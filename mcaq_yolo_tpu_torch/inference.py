"""
Predictor: the deployed MCAQ-YOLO inference program (port of
`mcaq_yolo_tpu/inference.py:31-371`).

Loads a flax msgpack checkpoint and its `.json` meta, letterboxes inputs on
the host, runs forward (quantization on, deploy temperature) + decode +
NMS on the device, and inverts the letterbox.  Results follow the
reference's contract: detections, inference_time_ms, avg_bits and the
P3-scale complexity / bit maps.  The command-line interface is not ported
yet.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .data.dataset import letterbox, unletterbox_boxes
from .device import DeviceLike, resolve_device
from .models.mcaq_yolo import MCAQYOLO
from .models.weights_io import COLLECTIONS, load_jax_variables, to_jax_variables
from .models.yolo import decode_and_nms
from .utils.checkpoint import load_checkpoint, load_meta


def auto_pre_topk(max_det: int, conf_threshold: float = 0.25) -> int:
    """NMS candidate-pool size: 256 for deployed gates (conf >= 0.25), 512
    for low-confidence eval gates.  The pool only has to cover the
    above-gate candidates; saturation is reported at run time."""
    del max_det
    return 256 if conf_threshold >= 0.25 else 512


def _overlay(template: Dict, src: Optional[Dict], path: str = "") -> Dict:
    """Keys absent from the checkpoint, or with another shape, keep the
    template's value, with a warning."""
    out = dict(template)
    for k, v in template.items():
        if src is None or k not in src:
            warnings.warn(f"[MCAQ] checkpoint missing {path}/{k}; keeping initialized value")
        elif isinstance(v, dict):
            out[k] = _overlay(v, src[k], f"{path}/{k}")
        elif tuple(np.shape(src[k])) == tuple(v.shape):
            out[k] = np.asarray(src[k], v.dtype)
        else:
            warnings.warn(f"[MCAQ] shape mismatch at {path}/{k} ({np.shape(src[k])} vs "
                          f"{v.shape}); keeping initialized value")
    return out


class Predictor:
    """Single-image / batch MCAQ-YOLO inference on one device.

    `dtype` is the network compute dtype (torch.bfloat16 for the deployed
    program); `device` defaults to CUDA and raises without one."""

    def __init__(self, model_path: str, num_classes: int = 80, variant: str = "yolov8n",
                 img_size: Optional[int] = None, conf_threshold: float = 0.25,
                 iou_threshold: float = 0.45, max_det: int = 1000,
                 pre_topk: Optional[int] = None, class_names: Optional[Dict[int, str]] = None,
                 bit_mapping: str = "mlp", grid_size: int = 8, warmup: bool = True,
                 min_bits: Optional[int] = None, max_bits: Optional[int] = None,
                 monotone_param: Optional[str] = None,
                 normalize_complexity: Optional[bool] = None,
                 morph_downsample: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        self.device = resolve_device(device)
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
            morph_downsample=morph_downsample, dtype=dtype, device=self.device)
        payload = load_checkpoint(model_path)
        template = to_jax_variables(self.model)
        load_jax_variables(self.model, {
            c: _overlay(template[c], payload.get(c)) for c in COLLECTIONS if c in template})
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
        """The deployed program: forward + decode + NMS on (B, S, S, 3) uint8."""
        raw, aux = self.model(images, temperature=self.deploy_temperature, quantize=True)
        *det, gated_count = decode_and_nms(
            raw, self.num_classes, conf_threshold=self.conf_threshold,
            iou_threshold=self.iou_threshold, max_det=self.max_det,
            pre_topk=self.pre_topk, with_pool_stats=True)
        return tuple(det) + (aux["avg_bits"], aux["complexity_map"][0],
                             aux["bit_map"][0], gated_count)

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

    def predict(self, image: np.ndarray) -> Dict:
        """image: HxWx3 uint8 RGB -> the reference's result contract."""
        img, scale, pad = self.preprocess(image)
        out, dt_ms = self._run(img[None])
        self._check_pool_headroom(out[-1])
        return self._results(out, 0, scale, pad, image.shape[:2], dt_ms)

    def predict_batch(self, images: Sequence[np.ndarray], batch_size: int = 16) -> List[Dict]:
        """Batched forwards over decoded HxWx3 uint8 images; the ragged tail
        is padded by repeating the last image so every chunk has one shape."""
        n = len(images)
        if n == 0:
            return []
        batch_size = min(batch_size, n)
        results: List[Dict] = []
        for i in range(0, n, batch_size):
            raw = list(images[i:i + batch_size])
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
