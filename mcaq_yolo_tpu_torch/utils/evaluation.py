"""
Detection evaluation (port of `mcaq_yolo_tpu/utils/evaluation.py`):
per-class AP with score-sorted greedy matching, mAP@0.5 and COCO-style
mAP@[.5:.95], host-side NumPy over the padded detections the device
returns; and the quantization-impact helpers of the evidence scripts
(raw-map divergence between the float and the quantized forward, its
correlation with complexity).

  * per-class AP over the union of ground-truth and detected classes; a
    class detected but never in the ground truth scores AP 0
  * VOC all-point or COCO 101-point interpolation
  * detections sorted by score, each ground-truth box matched at most once
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray, method: str = "voc") -> float:
    """AP from a PR curve: 'voc' all-point or 'coco' 101-point interpolation."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    if method == "coco":
        x = np.linspace(0, 1, 101)
        return float(np.trapezoid(np.interp(x, mrec, mpre), x))
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def compute_map(predictions: Sequence[Dict[str, np.ndarray]],
                targets: Sequence[Dict[str, np.ndarray]],
                iou_threshold: float = 0.5, method: str = "voc") -> Dict:
    """mAP over per-image prediction / target dicts.

    predictions[i]: {'boxes': (N,4) xyxy, 'scores': (N,), 'classes': (N,)}
    targets[i]:     {'boxes': (M,4) xyxy, 'classes': (M,)}

    Returns {'map': float, 'ap_per_class': {cls: ap}, 'num_images': int}."""
    if len(predictions) != len(targets):
        raise ValueError(f"{len(predictions)} predictions for {len(targets)} targets")

    gt_classes, det_classes = set(), set()
    for t in targets:
        gt_classes.update(np.asarray(t["classes"]).astype(int).tolist())
    for p in predictions:
        det_classes.update(np.asarray(p["classes"]).astype(int).tolist())

    ap_per_class = {}
    for cls in sorted(gt_classes | det_classes):
        if cls not in gt_classes:
            ap_per_class[cls] = 0.0  # a hallucinated class
            continue
        recs = []  # (score, image index, box)
        n_gt = 0
        gt_boxes_per_img = []
        for i, (p, t) in enumerate(zip(predictions, targets)):
            t_cls = np.asarray(t["classes"]).astype(int)
            t_box = np.asarray(t["boxes"], np.float32).reshape(-1, 4)
            sel_t = t_cls == cls
            gt_boxes_per_img.append(t_box[sel_t])
            n_gt += int(sel_t.sum())
            p_cls = np.asarray(p["classes"]).astype(int)
            p_box = np.asarray(p["boxes"], np.float32).reshape(-1, 4)
            p_score = np.asarray(p["scores"], np.float32)
            for j in np.where(p_cls == cls)[0]:
                recs.append((float(p_score[j]), i, p_box[j]))
        if not recs:
            ap_per_class[cls] = 0.0
            continue

        recs.sort(key=lambda r: -r[0])
        matched = [np.zeros(len(g), bool) for g in gt_boxes_per_img]
        tp = np.zeros(len(recs))
        fp = np.zeros(len(recs))
        for k, (_, i, box) in enumerate(recs):
            gts = gt_boxes_per_img[i]
            if len(gts) == 0:
                fp[k] = 1
                continue
            ious = _box_iou_np(box[None], gts)[0]
            best = int(np.argmax(ious))
            if ious[best] >= iou_threshold and not matched[i][best]:
                tp[k] = 1
                matched[i][best] = True
            else:
                fp[k] = 1
        tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
        recall = tp_cum / max(n_gt, 1)
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        ap_per_class[cls] = _ap_from_pr(recall, precision, method)

    mAP = float(np.mean(list(ap_per_class.values()))) if ap_per_class else 0.0
    return {"map": mAP, "ap_per_class": ap_per_class, "num_images": len(predictions)}


def compute_map50_95(predictions, targets, method: str = "coco") -> Dict:
    """COCO-style mAP@[.5:.95:.05]."""
    thresholds = np.arange(0.5, 1.0, 0.05)
    maps = [compute_map(predictions, targets, float(t), method)["map"] for t in thresholds]
    return {"map50": maps[0], "map50_95": float(np.mean(maps)),
            "per_threshold": {round(float(t), 2): m for t, m in zip(thresholds, maps)}}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def extract_targets_per_image(batch: Dict) -> List[Dict[str, np.ndarray]]:
    """Split a padded batch into per-image target dicts (padding rows
    dropped through gt_mask)."""
    boxes = _numpy(batch["gt_boxes"])
    classes = _numpy(batch["gt_classes"])
    mask = _numpy(batch["gt_mask"]).astype(bool)
    return [{"boxes": boxes[b][mask[b]], "classes": classes[b][mask[b]]}
            for b in range(boxes.shape[0])]


def detections_to_numpy(det_boxes, det_scores, det_classes, det_valid) -> List[Dict]:
    """Padded detections (B, max_det, ...) -> per-image numpy dicts."""
    boxes, scores, classes = _numpy(det_boxes), _numpy(det_scores), _numpy(det_classes)
    valid = _numpy(det_valid).astype(bool)
    return [{"boxes": boxes[b][valid[b]], "scores": scores[b][valid[b]],
             "classes": classes[b][valid[b]]} for b in range(boxes.shape[0])]


def evaluate_mcaq_yolo(forward_fn, dataloader, conf_threshold: float = 0.001,
                       iou_threshold: float = 0.65, max_det: int = 300,
                       output_json: Optional[str] = None) -> Dict:
    """Evaluation loop: mAP@0.5, mAP@[.5:.95], steady-state latency (the
    first batch left out), mean / std bits, compression ratio 32/avg_bits.

    forward_fn(images) returns (det_boxes, det_scores, det_classes,
    det_valid, avg_bits); its latency is taken on the host clock up to a
    `torch.cuda.synchronize` when the outputs lie on CUDA."""
    predictions, targets, bits_seen, latencies = [], [], [], []
    for batch in dataloader:
        t0 = time.perf_counter()
        out = forward_fn(batch["image"])
        if any(isinstance(o, torch.Tensor) and o.is_cuda for o in out):
            torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1000.0)
        det_boxes, det_scores, det_classes, det_valid, avg_bits = out
        predictions.extend(detections_to_numpy(det_boxes, det_scores, det_classes, det_valid))
        targets.extend(extract_targets_per_image(batch))
        bits_seen.append(float(avg_bits))

    res50 = compute_map(predictions, targets, 0.5)
    res_all = compute_map50_95(predictions, targets)
    avg_bits = float(np.mean(bits_seen)) if bits_seen else 0.0
    results = {
        "map50": res50["map"],
        "map50_95": res_all["map50_95"],
        "ap_per_class": res50["ap_per_class"],
        "avg_bits": avg_bits,
        "std_bits": float(np.std(bits_seen)) if bits_seen else 0.0,
        "compression_ratio": 32.0 / max(avg_bits, 1e-8),
        "latency_ms_mean": float(np.mean(latencies[1:] or latencies)),
        "latency_ms_std": float(np.std(latencies[1:] or latencies)),
        "num_images": len(predictions),
    }
    if output_json:
        with open(output_json, "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results


def analyze_complexity_correlation(complexity_scores: np.ndarray,
                                   sensitivities: np.ndarray) -> Dict:
    """Pearson and Spearman correlation between per-image complexity and
    quantization sensitivity (the output divergence between the float and an
    aggressively quantized forward)."""
    from scipy import stats

    c = np.asarray(complexity_scores, np.float64)
    s = np.asarray(sensitivities, np.float64)
    pearson = stats.pearsonr(c, s)
    spearman = stats.spearmanr(c, s)
    return {"pearson_r": float(pearson[0]), "pearson_p": float(pearson[1]),
            "spearman_r": float(spearman[0]), "spearman_p": float(spearman[1]),
            "n": int(c.size)}


def _per_image_divergence(fp_maps, q_maps) -> torch.Tensor:
    """Mean over scales of each image's mean squared difference of the raw
    maps (B, H, W, C)."""
    return sum(torch.mean((a.to(torch.float32) - b.to(torch.float32)) ** 2, dim=(1, 2, 3))
               for a, b in zip(fp_maps, q_maps)) / len(fp_maps)


@torch.no_grad()
def evaluate_quantization_impact(forward_fp_fn, forward_q_fn, dataloader,
                                 max_batches: int = 16) -> Dict:
    """Output divergence between the float (quantize=False) and the
    quantized forward: per-image mean squared divergence of the raw maps,
    and its mean / std / max.  forward_*_fn(images) -> raw per-scale maps."""
    divergences = []
    for i, batch in enumerate(dataloader):
        imgs = batch["image"]
        per_img = _per_image_divergence(forward_fp_fn(imgs), forward_q_fn(imgs))
        divergences.extend(_numpy(per_img).tolist())
        if i + 1 >= max_batches:
            break
    d = np.asarray(divergences)
    return {"mean_divergence": float(d.mean()), "std_divergence": float(d.std()),
            "max_divergence": float(d.max()), "per_image": d.tolist()}


@torch.no_grad()
def quantization_sensitivity(model_apply, images, temperature: float = 0.1) -> torch.Tensor:
    """Per-image sensitivity: the divergence between the unquantized forward
    and an aggressively quantized one (a low temperature, so few bits), the
    quantity `analyze_complexity_correlation` correlates with complexity.
    model_apply(images, temperature=..., quantize=...) -> raw per-scale maps."""
    fp_maps = model_apply(images, temperature=1.0, quantize=False)
    q_maps = model_apply(images, temperature=temperature, quantize=True)
    return _per_image_divergence(fp_maps, q_maps)
