"""
Batched greedy NMS (port of `mcaq_yolo_tpu/ops/nms.py`): `nms_from_topk`
on an already-selected, score-sorted candidate pool (the deployed
`decode_and_nms` path), and the separate path over decoded boxes and
per-class scores, `batched_nms` / `batched_nms_from_best` (batched; the
reference vmaps `non_max_suppression` / `nms_from_best`, which stay here
for one image).

keep(i) = alive(i) and no higher-scored KEPT candidate overlaps i above
the IoU threshold.  Computed as the Jacobi fixed point of that rule over
the (B, k, k) suppression matrix, starting from `alive`: its unique fixed
point is the sequential greedy result (induction over score order), the
same result the reference's fixed-point and block-sequential cores give.
Each sweep is one batched reduction; the loop stops when no keep bit
changes (the suppression chain depth, at most k sweeps, plus the sweep that
finds no change).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch._higher_order_ops import while_loop

from ..utils.profiling import count, span


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


def keep_fixed_point(suppress: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The keep sweeps as a Python loop that reads its stop condition on
    the host: the eager formulation.  Span 'nms.keep'; each sweep counts
    in `nms_sweeps`, and its read of the stop condition, one host sync, in
    `host_syncs` inside a span 'sync.nms_sweep'."""
    keep = alive
    with span("nms.keep"):
        for _ in range(suppress.shape[-1]):
            new = alive & ~(suppress & keep[..., :, None]).any(dim=-2)
            count("nms_sweeps")
            with span("sync.nms_sweep"):
                count("host_syncs")
                same = torch.equal(new, keep)
            if same:
                break
            keep = new
    return keep


def keep_fixed_point_traced(suppress: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The same sweeps in `while_loop` (the counterpart of the reference's
    `lax.while_loop`, `ops/nms.py:56-84`): one loop node under torch.export.
    Called eagerly, `while_loop` runs through torch.compile (seconds for the
    first call of each shape), so only traced programs take it."""
    k = suppress.shape[-1]

    def sweep(i, keep, changed):
        new = alive & ~(suppress & keep[..., :, None]).any(dim=-2)
        return i + 1, new, (new != keep).any()

    def more(i, keep, changed):
        return changed & (i < k)

    start = (torch.zeros((), dtype=torch.int64, device=alive.device), alive,
             torch.ones((), dtype=torch.bool, device=alive.device))
    return while_loop(more, sweep, start)[1]


def greedy_keep(nms_boxes: torch.Tensor, alive: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Exact sequential-greedy keep mask of score-sorted (B, k) candidates:
    `keep_fixed_point` eagerly, `keep_fixed_point_traced` under torch.export
    or torch.compile, so the deployed program exports with its NMS."""
    k = nms_boxes.shape[-2]
    idx = torch.arange(k, device=nms_boxes.device)
    # suppress[b, j, i]: higher-scored candidate j would suppress i if kept
    suppress = (iou_matrix(nms_boxes) > iou_threshold) & (idx[:, None] < idx[None, :])
    if torch.compiler.is_compiling():
        return keep_fixed_point_traced(suppress, alive)
    return keep_fixed_point(suppress, alive)


def nms_from_topk(top_boxes: torch.Tensor, top_scores: torch.Tensor,
                  top_classes: torch.Tensor, iou_threshold: float = 0.45,
                  max_det: int = 300, class_agnostic: bool = False):
    """top_boxes (B, k, 4) xyxy, top_scores (B, k) score-sorted with the
    confidence gate applied by zeroing, top_classes (B, k) int32 ->
    (boxes (B, max_det, 4), scores (B, max_det), classes (B, max_det),
    valid (B, max_det) bool), survivors first in score order."""
    B, k, _ = top_boxes.shape
    alive = top_scores > 0.0
    nms_boxes = top_boxes
    if not class_agnostic:
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


def batched_nms_from_best(boxes: torch.Tensor, best_scores: torch.Tensor,
                          best_classes: torch.Tensor, conf_threshold: float = 0.25,
                          iou_threshold: float = 0.45, max_det: int = 300,
                          pre_topk: int = 1024, class_agnostic: bool = False):
    """NMS on pre-reduced candidates: boxes (B, A, 4) xyxy, best_scores (B, A)
    per-anchor best-class score, best_classes (B, A) int32 -> padded
    detections as `nms_from_topk`.  The gate zeroes scores, then the top
    `pre_topk` (ties to the lowest index) enter the suppression."""
    gated = torch.where(best_scores >= conf_threshold, best_scores,
                        torch.zeros_like(best_scores))
    k = min(pre_topk, boxes.shape[1])
    top_scores, top_idx = stable_topk(gated, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(best_classes.to(torch.int32), 1, top_idx)
    return nms_from_topk(top_boxes, top_scores, top_classes, iou_threshold=iou_threshold,
                         max_det=max_det, class_agnostic=class_agnostic)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, **kwargs):
    """boxes (B, A, 4), per-class scores (B, A, nc) -> padded detections;
    keyword arguments as `batched_nms_from_best`."""
    best_scores, best_classes = scores.max(dim=-1)
    return batched_nms_from_best(boxes, best_scores, best_classes.to(torch.int32), **kwargs)


def nms_from_best(boxes: torch.Tensor, best_score: torch.Tensor, best_class: torch.Tensor,
                  **kwargs):
    """One image: boxes (A, 4), best_score (A,), best_class (A,) ->
    (boxes (max_det, 4), scores, classes, valid)."""
    det = batched_nms_from_best(boxes[None], best_score[None], best_class[None], **kwargs)
    return tuple(d[0] for d in det)


def non_max_suppression(boxes: torch.Tensor, scores: torch.Tensor, **kwargs):
    """One image: boxes (A, 4), per-class scores (A, nc) -> (boxes
    (max_det, 4), scores, classes, valid), score-sorted."""
    det = batched_nms(boxes[None], scores[None], **kwargs)
    return tuple(d[0] for d in det)
