"""Straight-through estimators: x + (f(x) - x).detach() — forward value
f(x), identity gradient w.r.t. x (mirrors `mcaq_yolo_tpu/core/ste.py`)."""

import torch


def ste(x: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    return x + (fx - x).detach()


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return ste(x, torch.round(x))


def ste_clamp(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return ste(x, torch.clamp(x, lo, hi))
