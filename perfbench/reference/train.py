"""
Plain float32 training step of MCAQ-YOLO: the benchmark's reference for the
loss (YOLOv8's task-aligned assignment, CIoU, BCE and DFL with gains 7.5 /
0.5 / 1.5; paper Eq.20 with the bit-budget, smoothness, distillation and
mapper-L2 terms) and the optimizer (clip to global norm 1.0, then AdamW
with bias correction, decay off for the bit mapper, and the Eq.18 |W|
projection of the mapper's Dense kernels and BatchNorm scales).

A frozen copy of the plain arithmetic of `mcaq_yolo_tpu_torch/models/
losses.py` and `train.py` (`Optimizer`, `make_train_step`) at commit
00c80e2, without data parallelism.  It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .network import REG_MAX, dfl, make_anchors


def box_iou(a, b, eps=1e-7):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda t: (torch.clamp(t[..., 2] - t[..., 0], min=0)  # noqa: E731
                      * torch.clamp(t[..., 3] - t[..., 1], min=0))
    return inter / (area(a) + area(b) - inter + eps)


def ciou(a, b, eps=1e-7):
    iou = box_iou(a, b, eps)
    cw = torch.maximum(a[..., 2], b[..., 2]) - torch.minimum(a[..., 0], b[..., 0])
    chh = torch.maximum(a[..., 3], b[..., 3]) - torch.minimum(a[..., 1], b[..., 1])
    c2 = cw ** 2 + chh ** 2 + eps
    rho2 = (((a[..., 0] + a[..., 2]) - (b[..., 0] + b[..., 2])) * 0.5) ** 2 \
        + (((a[..., 1] + a[..., 3]) - (b[..., 1] + b[..., 3])) * 0.5) ** 2
    wa = torch.clamp(a[..., 2] - a[..., 0], min=eps)
    ha = torch.clamp(a[..., 3] - a[..., 1], min=eps)
    wb = torch.clamp(b[..., 2] - b[..., 0], min=eps)
    hb = torch.clamp(b[..., 3] - b[..., 1], min=eps)
    v = (4.0 / math.pi ** 2) * (torch.atan(wb / hb) - torch.atan(wa / ha)) ** 2
    alpha = (v / torch.clamp(1.0 - iou + v, min=eps)).detach()
    return iou - rho2 / c2 - alpha * v


@torch.no_grad()
def assign(scores, boxes, points, gt_boxes, gt_classes, gt_mask, topk=10, alpha=0.5,
           beta=6.0, eps=1e-9):
    """Task-aligned assignment -> (target boxes (B, A, 4), target scores
    (B, A, nc), foreground (B, A))."""
    B, A, nc = scores.shape
    M = gt_boxes.shape[1]
    px, py = points[None, None, :, 0], points[None, None, :, 1]
    in_gts = ((px > gt_boxes[..., 0:1]) & (py > gt_boxes[..., 1:2])
              & (px < gt_boxes[..., 2:3]) & (py < gt_boxes[..., 3:4]))
    overlaps = torch.clamp(ciou(gt_boxes[:, :, None], boxes[:, None]), min=0.0)
    cls = torch.clamp(gt_classes.to(torch.int64), 0, nc - 1)
    s = torch.gather(scores.transpose(1, 2), 1, cls[:, :, None].expand(B, M, A))
    candidate = in_gts & gt_mask.to(torch.bool)[:, :, None]
    align = torch.where(candidate, s ** alpha * overlaps ** beta, 0.0)
    iota = torch.arange(A, device=align.device)[None, None]
    top = torch.zeros_like(align, dtype=torch.bool)
    work = align
    for _ in range(topk):
        val, idx = work.amax(-1), torch.argmax(work, -1)
        pick = (iota == idx[..., None]) & (val > eps)[..., None]
        top |= pick
        work = torch.where(pick, -1.0, work)
    pos = top & candidate
    best = torch.argmax(torch.where(pos, overlaps, -1.0), dim=1)
    is_best = torch.arange(M, device=align.device)[None, :, None] == best[:, None]
    pos = torch.where(pos.sum(1, keepdim=True) > 1, pos & is_best, pos)
    fg = pos.any(1)
    gt_of = torch.argmax(pos.to(torch.uint8), dim=1)
    tb = torch.gather(gt_boxes, 1, gt_of[..., None].expand(B, A, 4))
    tc = torch.gather(gt_classes.to(torch.int64), 1, gt_of)
    a_pos = torch.where(pos, align, 0.0)
    norm = a_pos * torch.where(pos, overlaps, 0.0).amax(2, keepdim=True) \
        / (a_pos.amax(2, keepdim=True) + eps)
    onehot = (tc[..., None] == torch.arange(nc, device=tc.device)).to(torch.float32)
    return tb, onehot * norm.amax(1)[..., None] * fg[..., None].to(torch.float32), fg


def detection_loss(raw, gt_boxes, gt_classes, gt_mask):
    B = raw[0].shape[0]
    points, strides = make_anchors([m.shape[1:3] for m in raw], raw[0].device)
    flat = torch.cat([m.reshape(B, -1, m.shape[-1]) for m in raw], 1).to(torch.float32)
    pd = flat[..., :4 * REG_MAX].reshape(B, -1, 4, REG_MAX)
    logits = flat[..., 4 * REG_MAX:]
    d = dfl(pd)
    pb = torch.cat([points[None] - d[..., :2], points[None] + d[..., 2:]], -1)
    tb, ts, fg = assign(torch.sigmoid(logits).detach(), (pb * strides[None]).detach(),
                        points * strides, gt_boxes, gt_classes, gt_mask)
    tss = torch.clamp(ts.sum(), min=1.0)
    bce = torch.clamp(logits, min=0) - logits * ts + torch.log1p(torch.exp(-logits.abs()))
    loss_cls = bce.sum() / tss
    tb_s = tb / strides[None]
    w = ts.sum(-1) * fg
    loss_box = ((1.0 - ciou(pb, tb_s)) * w).sum() / tss
    t = torch.clamp(torch.cat([points[None] - tb_s[..., :2], tb_s[..., 2:] - points[None]], -1),
                    0.0, REG_MAX - 1 - 0.01)
    tl = torch.floor(t).to(torch.int64)
    wl = (tl + 1).to(t.dtype) - t
    logp = F.log_softmax(pd, -1)
    def lp(i):
        return torch.gather(logp, -1, torch.clamp(i, 0, REG_MAX - 1)[..., None])[..., 0]

    dfl_l = -(lp(tl) * wl + lp(tl + 1) * (1.0 - wl))
    loss_dfl = (dfl_l.mean(-1) * w).sum() / tss
    return 7.5 * loss_box + 0.5 * loss_cls + 1.5 * loss_dfl


def matched_mse(student, teacher):
    terms = [((s.to(torch.float32) - t.detach().to(torch.float32)) ** 2).mean()
             for s, t in zip(student, teacher) if s.shape == t.shape]
    return sum(terms) / len(terms)


def smoothness(bit_maps):
    total = 0.0
    for b in bit_maps:
        dx = (b[:, 1:, :] - b[:, :-1, :]).abs()
        dy = (b[:, :, 1:] - b[:, :, :-1]).abs()
        total = total + (dx.sum() + dy.sum()) / max(1, dx.numel() + dy.numel())
    return total / len(bit_maps)


def mapper_l2(mapper):
    return sum((p ** 2).sum() for p in mapper.parameters() if p.dim() > 1)


def total_loss(raw, aux, batch, teacher_raw, teacher_feats, mapper, train: Dict):
    w = train["loss_weights"]
    loss = (w["detection"] * detection_loss(raw, batch["gt_boxes"], batch["gt_classes"],
                                            batch["gt_mask"])
            + w["bit_budget"] * (aux["avg_bits"] - train["target_bits"]) ** 2
            + w["smoothness"] * smoothness(aux["bit_map"])
            + w["distillation"] * (matched_mse(raw, teacher_raw)
                                   + matched_mse(aux["quantized"], teacher_feats))
            + w["regularization"] * mapper_l2(mapper))
    return loss


class AdamW:
    """Clip to global norm `max_norm`, then AdamW (decoupled decay, bias
    correction); `decay[name]` False leaves a parameter undecayed."""

    def __init__(self, named, lr, weight_decay, betas=(0.9, 0.999), eps=1e-8, max_norm=1.0,
                 decay=None):
        self.named = list(named)
        self.lr, self.wd, self.betas, self.eps, self.max_norm = lr, weight_decay, betas, eps, \
            max_norm
        self.decay = decay or {}
        self.m = {n: torch.zeros_like(p) for n, p in self.named}
        self.v = {n: torch.zeros_like(p) for n, p in self.named}
        self.t = 0
        self.last_clipped: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self):
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.named}
        norm = float(torch.sqrt(sum((g.to(torch.float64) ** 2).sum() for g in grads.values())))
        factor = 1.0 if norm < self.max_norm else self.max_norm / norm
        self.t += 1
        b1, b2 = self.betas
        self.last_clipped = {}
        for n, p in self.named:
            g = grads[n] * factor
            self.last_clipped[n] = g.clone()
            if self.decay.get(n, True):
                p.mul_(1.0 - self.lr * self.wd)
            self.m[n].mul_(b1).add_((1 - b1) * g)
            self.v[n].mul_(b2).add_((1 - b2) * g * g)
            mh = self.m[n] / (1 - b1 ** self.t)
            vh = self.v[n] / (1 - b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
        return norm


@torch.no_grad()
def project_mapper(mapper: nn.Module):
    """Eq.(18): |W| of the mapper's Dense kernels and BatchNorm scales."""
    for m in mapper.modules():
        if isinstance(m, (nn.Linear, nn.BatchNorm1d)):
            m.weight.abs_()


def step(model, teacher, opt: AdamW, batch, train: Dict) -> torch.Tensor:
    """One training step of `model` (MCAQYOLO in training mode) -> the loss
    before the update."""
    with torch.no_grad():
        t_feats = teacher.features(batch["image"])
        t_raw = teacher.head(teacher.neck(*t_feats))
    raw, aux = model(batch["image"], temperature=train["temperature"], training=True)
    loss = total_loss(raw, aux, batch, t_raw, [f.permute(0, 2, 3, 1) for f in t_feats],
                      model.bit_mapper, train)
    for _, p in opt.named:
        p.grad = None
    loss.backward()
    opt.step()
    project_mapper(model.bit_mapper)
    return loss.detach()


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    return {n: "bit_mapper" not in n.split(".") for n, _ in model.named_parameters()}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.to(torch.float64).norm()) for n, t in tensors.items()}

