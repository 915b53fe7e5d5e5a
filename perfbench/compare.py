"""
The numbers that decide `correct`: what the timed path produced against
the plain reference on the same inputs.  Each number is a gap (0 = the
reference exactly); `perfbench/limits/<cell>.json` holds its limit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def same_shapes(p: Sequence[torch.Tensor], r: Sequence[torch.Tensor]) -> bool:
    return p is not None and len(p) == len(r) and all(a.shape == b.shape for a, b in zip(p, r))


def rel_err(p: Sequence[torch.Tensor], r: Sequence[torch.Tensor]) -> float:
    """||p - r|| / ||r|| over all the tensors together (inf when the shapes
    differ)."""
    if not same_shapes(p, r):
        return float("inf")
    num = sum(float((a.to(torch.float64) - b.to(torch.float64)).square().sum())
              for a, b in zip(p, r))
    den = sum(float(b.to(torch.float64).square().sum()) for b in r)
    return (num / max(den, 1e-300)) ** 0.5


def bits_mismatch(p: Sequence[torch.Tensor], r: Sequence[torch.Tensor]) -> float:
    """Share of tiles whose integer bit width differs (1 when the shapes
    differ)."""
    if not same_shapes(p, r):
        return 1.0
    diff = sum(int((torch.round(a.float()) != torch.round(b.float())).sum()) for a, b in zip(p, r))
    return diff / sum(b.numel() for b in r)


def mean_abs(p: Sequence[torch.Tensor], r: Sequence[torch.Tensor]) -> float:
    if not same_shapes(p, r):
        return float("inf")
    tot = sum(float((a.float() - b.float()).abs().sum()) for a, b in zip(p, r))
    return tot / sum(b.numel() for b in r)


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-9)


def match(pb, pc, rb, rs, rc, iou: float = 0.5):
    """Greedy one-to-one matches (reference index, program index), in the
    reference's score order, of detections of the same class overlapping
    by `iou` or more."""
    if len(rb) == 0 or len(pb) == 0:
        return []
    ov = _iou(rb.float(), pb.float())
    ov = torch.where(rc[:, None].long() == pc[None].long(), ov, torch.zeros_like(ov))
    used = torch.zeros(len(pb), dtype=torch.bool, device=ov.device)
    pairs = []
    for i in torch.argsort(rs.float(), descending=True, stable=True).tolist():
        cand = torch.where(used, torch.full_like(ov[i], -1.0), ov[i])
        j = int(torch.argmax(cand))
        if float(cand[j]) >= iou:
            used[j] = True
            pairs.append((i, j))
    return pairs


def _pairs(prog, ref):
    for p, r in zip(prog, ref):
        yield p, r, match(p["boxes"], p["classes"], r["boxes"], r["scores"], r["classes"])


def det_mismatch(prog: List[Dict[str, torch.Tensor]], ref: List[Dict[str, torch.Tensor]]) -> float:
    """1 - 2 matched / (program's + reference's detections), over all
    images (each a dict of boxes, scores, classes); 0 when neither has any,
    1 when the image counts differ."""
    if len(prog) != len(ref):
        return 1.0
    m = n = 0
    for p, r, pairs in _pairs(prog, ref):
        m += len(pairs)
        n += len(p["boxes"]) + len(r["boxes"])
    return 0.0 if n == 0 else 1.0 - 2.0 * m / n


def det_box_gap(prog: List[Dict[str, torch.Tensor]], ref: List[Dict[str, torch.Tensor]]) -> float:
    """Mean over matched detections of the largest coordinate difference of
    the two boxes, in pixels (0 when nothing matched; inf when the image
    counts differ)."""
    if len(prog) != len(ref):
        return float("inf")
    gaps = [float((p["boxes"][j].double() - r["boxes"][i].double()).abs().max())
            for p, r, pairs in _pairs(prog, ref) for i, j in pairs]
    return sum(gaps) / len(gaps) if gaps else 0.0


def per_image(boxes, scores, classes, valid) -> List[Dict[str, torch.Tensor]]:
    out = []
    for b in range(boxes.shape[0]):
        v = valid[b].bool()
        out.append({"boxes": boxes[b][v], "scores": scores[b][v], "classes": classes[b][v]})
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: Sequence[str]):
    """Per leaf: |norm_p - norm_r| / max(norm_r, the median leaf's norm_r)."""
    norms = sorted(ref[k] for k in keep)
    med = norms[len(norms) // 2] if norms else 0.0
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: Sequence[str]) -> float:
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: Sequence[str]) -> float:
    gaps = sorted(leaf_gaps(prog, ref, keep).values())
    return gaps[len(gaps) // 2] if gaps else 0.0


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], keep: Sequence[str], n: int = 6):
    """The `n` leaves of the largest gaps: [name, gap, norm_p, norm_r]."""
    gaps = leaf_gaps(prog, ref, keep)
    return [[k, gaps[k], prog[k], ref[k]] for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]
