"""
Detection loss (YOLOv8: task-aligned assignment + CIoU + BCE + DFL) and the
combined MCAQ loss, paper Eq.20 (port of `mcaq_yolo_tpu/models/losses.py`).

Targets are fixed-shape and padded per batch:
    gt_boxes   (B, M, 4) xyxy, input pixels
    gt_classes (B, M)    integer
    gt_mask    (B, M)    validity (False rows are padding)

The assigner is the reference's fixed-shape formulation over a (B, M, A)
grid: top-k per ground truth by k rounds of first-max argmax and knock-out,
conflicts resolved by the larger overlap.  It builds targets and runs
without gradient on detached scores and boxes, as the reference does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .yolo import REG_MAX, dfl_decode, make_anchors

# ---------------------------------------------------------------------------
# IoU family
# ---------------------------------------------------------------------------


def box_iou_pairwise(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Plain IoU between broadcastable (..., 4) xyxy boxes."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    return inter / (area_a + area_b - inter + eps)


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between broadcastable (..., 4) xyxy boxes; the
    aspect-ratio weight alpha carries no gradient."""
    iou = box_iou_pairwise(a, b, eps)
    cw = torch.maximum(a[..., 2], b[..., 2]) - torch.minimum(a[..., 0], b[..., 0])
    ch = torch.maximum(a[..., 3], b[..., 3]) - torch.minimum(a[..., 1], b[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    ax = (a[..., 0] + a[..., 2]) * 0.5
    ay = (a[..., 1] + a[..., 3]) * 0.5
    bx = (b[..., 0] + b[..., 2]) * 0.5
    by = (b[..., 1] + b[..., 3]) * 0.5
    rho2 = (ax - bx) ** 2 + (ay - by) ** 2
    aw = torch.clamp(a[..., 2] - a[..., 0], min=eps)
    ah = torch.clamp(a[..., 3] - a[..., 1], min=eps)
    bw = torch.clamp(b[..., 2] - b[..., 0], min=eps)
    bh = torch.clamp(b[..., 3] - b[..., 1], min=eps)
    v = (4.0 / (math.pi ** 2)) * (torch.atan(bw / bh) - torch.atan(aw / ah)) ** 2
    alpha = (v / torch.clamp(1.0 - iou + v, min=eps)).detach()
    return iou - rho2 / c2 - alpha * v


# ---------------------------------------------------------------------------
# Task-aligned assigner
# ---------------------------------------------------------------------------


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of the last axis; out-of-range indices give zeros
    (jax.nn.one_hot's rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


@torch.no_grad()
def task_aligned_assign(pred_scores, pred_boxes, anchor_points, gt_boxes, gt_classes,
                        gt_mask, topk: int = 10, alpha: float = 0.5, beta: float = 6.0,
                        eps: float = 1e-9):
    """pred_scores (B, A, nc) sigmoid probabilities, pred_boxes (B, A, 4)
    and anchor_points (A, 2) in the ground truth's units ->
    (target_boxes (B, A, 4), target_scores (B, A, nc), fg_mask (B, A))."""
    B, A, nc = pred_scores.shape
    M = gt_boxes.shape[1]
    gt_valid = gt_mask.to(torch.bool)

    px = anchor_points[None, None, :, 0]
    py = anchor_points[None, None, :, 1]
    in_gts = ((px > gt_boxes[..., 0:1]) & (py > gt_boxes[..., 1:2])
              & (px < gt_boxes[..., 2:3]) & (py < gt_boxes[..., 3:4]))   # (B, M, A)

    overlaps = torch.clamp(ciou(gt_boxes[:, :, None, :], pred_boxes[:, None, :, :]), min=0.0)

    cls_idx = torch.clamp(gt_classes.to(torch.int64), 0, nc - 1)     # (B, M)
    s = torch.gather(pred_scores.transpose(1, 2), 1,
                     cls_idx[:, :, None].expand(B, M, A))             # (B, M, A)

    align = (s ** alpha) * (overlaps ** beta)
    candidate = in_gts & gt_valid[:, :, None]
    align = torch.where(candidate, align, 0.0)

    # top-k per ground truth: k rounds of (first-max argmax, knock out)
    anchor_iota = torch.arange(A, device=align.device)[None, None]
    mask_topk = torch.zeros_like(align, dtype=torch.bool)
    work = align
    for _ in range(topk):
        idx = torch.argmax(work, dim=-1)
        val = work.amax(dim=-1)
        pick = (anchor_iota == idx[..., None]) & (val > eps)[..., None]
        mask_topk = mask_topk | pick
        work = torch.where(pick, -1.0, work)
    mask_pos = mask_topk & candidate

    # an anchor claimed by several ground truths goes to the largest overlap
    n_claims = mask_pos.sum(dim=1, keepdim=True)
    best_gt = torch.argmax(torch.where(mask_pos, overlaps, -1.0), dim=1)       # (B, A)
    is_best = torch.arange(M, device=align.device)[None, :, None] == best_gt[:, None, :]
    mask_pos = torch.where(n_claims > 1, mask_pos & is_best, mask_pos)

    fg_mask = mask_pos.any(dim=1)
    assigned_gt = torch.argmax(mask_pos.to(torch.uint8), dim=1)  # 0 where not fg

    tb = torch.gather(gt_boxes, 1, assigned_gt[..., None].expand(B, A, 4))
    tc = torch.gather(gt_classes.to(torch.int64), 1, assigned_gt)

    align_pos = torch.where(mask_pos, align, 0.0)
    pos_align_max = align_pos.amax(dim=2, keepdim=True)
    pos_overlap_max = torch.where(mask_pos, overlaps, 0.0).amax(dim=2, keepdim=True)
    norm_align = align_pos * pos_overlap_max / (pos_align_max + eps)
    anchor_score = norm_align.amax(dim=1)

    target_scores = (_one_hot(tc, nc) * anchor_score[..., None]
                     * fg_mask[..., None].to(torch.float32))
    return tb, target_scores, fg_mask


# ---------------------------------------------------------------------------
# YOLOv8 detection loss
# ---------------------------------------------------------------------------


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the reference's
    stable form."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: cross-entropy against the two integer bins
    around the continuous target.  pred_dist (..., REG_MAX) logits, target
    (...,) in [0, REG_MAX - 1]."""
    tl = torch.floor(target).to(torch.int64)
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, dim=-1)
    ll = torch.gather(logp, -1, torch.clamp(tl, 0, REG_MAX - 1)[..., None])[..., 0]
    lr = torch.gather(logp, -1, torch.clamp(tr, 0, REG_MAX - 1)[..., None])[..., 0]
    return -(ll * wl + lr * wr)


class DetectionLoss:
    """TAL-assigned CIoU + BCE + DFL with the YOLOv8 gains (box 7.5, cls
    0.5, dfl 1.5).  Returns (loss_vec (3,), items)."""

    def __init__(self, num_classes: int = 80, box_gain: float = 7.5,
                 cls_gain: float = 0.5, dfl_gain: float = 1.5):
        self.nc = num_classes
        self.box_gain, self.cls_gain, self.dfl_gain = box_gain, cls_gain, dfl_gain

    def __call__(self, raw_maps: Sequence[torch.Tensor], gt_boxes, gt_classes, gt_mask):
        B = raw_maps[0].shape[0]
        points, strides = make_anchors([m.shape[1:3] for m in raw_maps],
                                       device=raw_maps[0].device)   # feature units
        flat = torch.cat([m.reshape(B, -1, m.shape[-1]) for m in raw_maps],
                         dim=1).to(torch.float32)
        pred_dist = flat[..., :4 * REG_MAX].reshape(B, -1, 4, REG_MAX)
        cls_logits = flat[..., 4 * REG_MAX:]
        pred_scores = torch.sigmoid(cls_logits)

        dist = dfl_decode(pred_dist)                                  # (B, A, 4)
        pb = torch.cat([points[None] - dist[..., :2], points[None] + dist[..., 2:]], dim=-1)
        # the assigner compares in pixels; box and DFL losses in stride units
        tb, target_scores, fg_mask = task_aligned_assign(
            pred_scores.detach(), (pb * strides[None]).detach(), points * strides,
            gt_boxes, gt_classes, gt_mask)

        tss = torch.clamp(target_scores.sum(), min=1.0)
        loss_cls = bce_with_logits(cls_logits, target_scores).sum() / tss

        tb_s = tb / strides[None]
        weight = target_scores.sum(-1) * fg_mask
        loss_box = ((1.0 - ciou(pb, tb_s)) * weight).sum() / tss

        t_dist = torch.clamp(torch.cat([points[None] - tb_s[..., :2],
                                        tb_s[..., 2:] - points[None]], dim=-1),
                             0.0, REG_MAX - 1 - 0.01)
        loss_dfl = (dfl_loss(pred_dist, t_dist).mean(-1) * weight).sum() / tss

        loss_vec = torch.stack([self.box_gain * loss_box, self.cls_gain * loss_cls,
                                self.dfl_gain * loss_dfl])
        items = {"box_loss": loss_vec[0], "cls_loss": loss_vec[1], "dfl_loss": loss_vec[2],
                 "num_fg": fg_mask.sum()}
        return loss_vec, items


# ---------------------------------------------------------------------------
# Knowledge distillation and the MCAQ terms
# ---------------------------------------------------------------------------


def _matched_mse(student: Sequence[torch.Tensor], teacher: Sequence[torch.Tensor]):
    """Mean over matched-shape pairs of the MSE against the detached
    teacher; pairs of other shapes are skipped, no pair gives 0."""
    losses = [torch.mean((s.to(torch.float32) - t.detach().to(torch.float32)) ** 2)
              for s, t in zip(student, teacher) if s.shape == t.shape]
    if not losses:
        return torch.zeros((), device=student[0].device if student else None)
    return sum(losses) / len(losses)


def kd_logit_loss(student_maps, teacher_maps) -> torch.Tensor:
    """Logit-level distillation: MSE over matched raw Detect maps."""
    return _matched_mse(student_maps, teacher_maps)


def kd_feature_loss(student_feats, teacher_feats) -> torch.Tensor:
    """Feature-level distillation: MSE between matched backbone features
    (both NHWC)."""
    return _matched_mse(student_feats, teacher_feats)


def smoothness_loss(bit_map) -> torch.Tensor:
    """Lsmooth: per-edge mean |db| over tile neighbours, averaged over
    scales when given a list."""
    if isinstance(bit_map, (list, tuple)):
        losses = [smoothness_loss(m) for m in bit_map]
        return sum(losses) / max(1, len(losses))
    if bit_map.dim() == 2:
        bit_map = bit_map[None]
    dx = torch.abs(bit_map[:, 1:, :] - bit_map[:, :-1, :])
    dy = torch.abs(bit_map[:, :, 1:] - bit_map[:, :, :-1])
    return (dx.sum() + dy.sum()) / max(1, dx.numel() + dy.numel())


def bit_budget_loss(avg_bits: torch.Tensor, target_bits) -> torch.Tensor:
    """Lbit = (b_bar - b_target)^2."""
    return (avg_bits - target_bits) ** 2


def mapper_l2(mapper: Optional[nn.Module]) -> torch.Tensor:
    """Lreg: L2 over the bit mapper's weight matrices (parameters with
    ndim > 1: Dense kernels, or MonotoneDense's raw theta)."""
    params = [p for p in mapper.parameters() if p.dim() > 1] if mapper is not None else []
    if not params:
        return torch.zeros(())
    return sum((p.to(torch.float32) ** 2).sum() for p in params)


DEFAULT_LOSS_WEIGHTS = {"detection": 1.0, "bit_budget": 0.01, "smoothness": 0.1,
                        "distillation": 0.5, "regularization": 1e-4}


class MCAQYOLOLoss:
    """L = Ldet + l1 Lbit + l2 Lsmooth + l3 LKD + l4 Lreg (paper Eq.20); the
    weights come per epoch from the CurriculumScheduler."""

    def __init__(self, num_classes: int = 80, target_bits: float = 4.0):
        self.detection_loss = DetectionLoss(num_classes)
        self.target_bits = target_bits

    def __call__(self, raw_maps, batch: Dict[str, torch.Tensor], aux_info: Dict,
                 teacher_maps=None, mapper: Optional[nn.Module] = None,
                 loss_weights: Optional[Dict] = None, target_bits=None):
        if loss_weights is None:
            loss_weights = DEFAULT_LOSS_WEIGHTS
        if target_bits is None:
            target_bits = self.target_bits
        device = raw_maps[0].device

        loss_vec, items = self.detection_loss(raw_maps, batch["gt_boxes"],
                                              batch["gt_classes"], batch["gt_mask"])
        loss_det = loss_vec.sum()
        loss_bit = bit_budget_loss(aux_info["avg_bits"], target_bits)
        loss_smooth = smoothness_loss(aux_info["bit_map"])
        loss_kd = torch.zeros((), device=device)
        if teacher_maps is not None:
            loss_kd = kd_logit_loss(raw_maps, teacher_maps)
        if "kd_feature_loss" in aux_info:
            loss_kd = loss_kd + aux_info["kd_feature_loss"]
        loss_reg = mapper_l2(mapper).to(device)

        total = (loss_weights["detection"] * loss_det
                 + loss_weights["bit_budget"] * loss_bit
                 + loss_weights["smoothness"] * loss_smooth
                 + loss_weights["distillation"] * loss_kd
                 + loss_weights["regularization"] * loss_reg)
        loss_dict = {"loss_det": loss_det, "loss_bit": loss_bit, "loss_smooth": loss_smooth,
                     "loss_kd": loss_kd, "loss_reg": loss_reg, "loss_total": total, **items}
        return total, loss_dict
