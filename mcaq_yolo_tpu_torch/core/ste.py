"""Straight-through estimators: x + (f(x) - x).detach() — forward value
f(x), identity gradient w.r.t. x (mirrors `mcaq_yolo_tpu/core/ste.py`) —
and `clip`, jnp.clip's gradient rule for clips on a gradient path."""

import torch

from ..utils.profiling import count, span


def ste(x: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    return x + (fx - x).detach()


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return ste(x, torch.round(x))


def ste_clamp(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return ste(x, torch.clamp(x, lo, hi))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi), as jnp.clip computes it: the forward value of
    torch.clamp, but at x == lo or x == hi the gradient is split in half
    (torch.maximum / minimum split ties, as lax.max / min do), where
    torch.clamp passes it whole.  Its two bounds are copied from the host
    on every call: two host syncs (`host_syncs`, span 'sync.clip_bounds')."""
    with span("sync.clip_bounds"):
        count("host_syncs", 2)
        return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))
