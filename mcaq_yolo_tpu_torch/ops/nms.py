"""
Batched greedy NMS on an already-selected, score-sorted candidate pool
(port of `mcaq_yolo_tpu/ops/nms.py:39-260`, `nms_from_topk` vmapped).

keep(i) = alive(i) and no higher-scored KEPT candidate overlaps i above
the IoU threshold.  Computed as the Jacobi fixed point of that rule over
the (B, k, k) suppression matrix, starting from `alive`: its unique fixed
point is the sequential greedy result (induction over score order), the
same result the reference's fixed-point and block-sequential cores give.
Each sweep is one batched reduction; the loop stops when no keep bit
changes (the suppression chain depth, at most k sweeps).
"""

from __future__ import annotations

from typing import Tuple

import torch


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties to the LOWEST index —
    `lax.top_k`'s order, which torch.topk does not promise."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def iou_matrix(boxes: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(..., N, 4) xyxy -> (..., N, N) IoU."""
    a = boxes[..., :, None, :]
    b = boxes[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    return inter / (area[..., :, None] + area[..., None, :] - inter + eps)


def greedy_keep(nms_boxes: torch.Tensor, alive: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Exact sequential-greedy keep mask of score-sorted (B, k) candidates."""
    k = nms_boxes.shape[-2]
    idx = torch.arange(k, device=nms_boxes.device)
    # suppress[b, j, i]: higher-scored candidate j would suppress i if kept
    suppress = (iou_matrix(nms_boxes) > iou_threshold) & (idx[:, None] < idx[None, :])
    keep = alive
    for _ in range(k):
        new = alive & ~(suppress & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_from_topk(top_boxes: torch.Tensor, top_scores: torch.Tensor,
                  top_classes: torch.Tensor, iou_threshold: float = 0.45,
                  max_det: int = 300):
    """top_boxes (B, k, 4) xyxy, top_scores (B, k) score-sorted with the
    confidence gate applied by zeroing, top_classes (B, k) int32 ->
    (boxes (B, max_det, 4), scores (B, max_det), classes (B, max_det),
    valid (B, max_det) bool), survivors first in score order."""
    B, k, _ = top_boxes.shape
    alive = top_scores > 0.0
    # class-aware: offset each class by the full coordinate span (corners
    # can be negative), so boxes of different classes never overlap
    span = (top_boxes.amax(dim=(1, 2)) - top_boxes.amin(dim=(1, 2)) + 1.0)
    nms_boxes = top_boxes + top_classes.to(top_boxes.dtype)[..., None] * span[:, None, None]
    keep = greedy_keep(nms_boxes, alive, iou_threshold)

    final_scores = torch.where(keep, top_scores, torch.zeros_like(top_scores))
    out_scores, order = stable_topk(final_scores, min(max_det, k))
    out_boxes = torch.gather(top_boxes, 1, order[..., None].expand(-1, -1, 4))
    out_classes = torch.gather(top_classes, 1, order)
    out_valid = out_scores > 0.0
    if max_det > k:
        pad = max_det - k
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    return out_boxes, out_scores, out_classes, out_valid
