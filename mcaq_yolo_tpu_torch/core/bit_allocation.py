"""
Bit allocation — complexity -> per-tile bit width (paper Eq.13-18) (port
of `mcaq_yolo_tpu/core/bit_allocation.py:28-308`).

  * `ComplexityToBitMappingNetwork` — z0 = [C, C^2, log1p(C)] ->
    32 -> 64 -> 32 -> 1 with BatchNorm, sigmoid scaled to [bmin, bmax],
    temperature multiply (floored at 0.1), straight-through clamp and
    round.  monotone_param 'softplus' uses `MonotoneDense` (kernel =
    softplus(theta)) and leaky-ReLU 0.05; 'abs' uses plain Linear layers
    (|W| projected during training) and ReLU.
  * `LinearBitMapper` — parameter-free percentile-normalized mapping.
  * `ConstantBitMapper` — uniform bits (matched-budget control).
  * `enforce_monotonic_params` — the Eq.18 |W| projection after each
    optimizer step; `get_bit_statistics` — mean, std, range and the
    integer-bit histogram of a bit map.

Every mapper takes `training`: the MLP's BatchNorm then uses the batch's
statistics and updates its running ones (flax momentum 0.9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import initializers as init
from ..batch_norm import BatchNorm1d
from .ste import ste_clamp, ste_round


def normalize_complexity_shape(complexity: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (1, H, W); (B, H, W) unchanged; (B, H, W, C) -> channel mean."""
    if complexity.dim() == 2:
        return complexity[None]
    if complexity.dim() == 3:
        return complexity
    if complexity.dim() == 4:
        return complexity.mean(dim=-1)
    raise ValueError(f"Unsupported complexity ndim={complexity.dim()}, expected 2-4.")


def _finalize_bit_map(bit_map: torch.Tensor, min_bits: float, max_bits: float,
                      temperature: Optional[float], return_continuous: bool) -> torch.Tensor:
    """Temperature multiply (floored at 0.1, in float32 like the
    reference), STE clamp, optional STE round."""
    if temperature is not None:
        t = max(np.float32(temperature), np.float32(0.1))
        bit_map = bit_map * float(t)
    bit_map = ste_clamp(bit_map, min_bits, max_bits)
    if not return_continuous:
        bit_map = ste_round(bit_map)
    return bit_map


def percentile_normalize(c: torch.Tensor, eps_spread: float = 1e-3) -> torch.Tensor:
    """Per-image 2-98% percentile normalization; a flat map (spread below
    eps_spread) keeps its absolute complexity."""
    B = c.shape[0]
    flat = c.reshape(B, -1).to(torch.float32)
    q = torch.quantile(flat, torch.tensor([0.02, 0.98], device=c.device), dim=1)
    lo = q[0].reshape(B, 1, 1)
    hi = q[1].reshape(B, 1, 1)
    spread = hi - lo
    rel = torch.clamp((c - lo) / (spread + 1e-8), 0.0, 1.0)
    return torch.where(spread > eps_spread, rel, torch.clamp(c, 0.0, 1.0))


def linear_bit_map(complexity: torch.Tensor, min_bits: float = 2.0, max_bits: float = 8.0,
                   temperature: Optional[float] = None, return_continuous: bool = False,
                   eps_spread: float = 1e-3) -> torch.Tensor:
    """b = bmin + (bmax - bmin) * percentile_normalize(C)."""
    c = normalize_complexity_shape(complexity)
    cn = percentile_normalize(c, eps_spread)
    bit_map = min_bits + (max_bits - min_bits) * cn
    return _finalize_bit_map(bit_map, min_bits, max_bits, temperature, return_continuous)


class LinearBitMapper(nn.Module):
    def __init__(self, min_bits: int = 2, max_bits: int = 8, eps_spread: float = 1e-3):
        super().__init__()
        self.min_bits, self.max_bits, self.eps_spread = min_bits, max_bits, eps_spread

    def forward(self, complexity, temperature=None, return_continuous=False,
                training=False):
        del training  # parameter-free; no BatchNorm
        return linear_bit_map(complexity, float(self.min_bits), float(self.max_bits),
                              temperature, return_continuous, self.eps_spread)


class ConstantBitMapper(nn.Module):
    def __init__(self, bits: float = 4.0, min_bits: int = 2, max_bits: int = 8):
        super().__init__()
        self.bits, self.min_bits, self.max_bits = bits, min_bits, max_bits

    def forward(self, complexity, temperature=None, return_continuous=False,
                training=False):
        del temperature, training
        b = float(min(max(self.bits, self.min_bits), self.max_bits))
        if not return_continuous:
            b = round(b)
        return torch.full(complexity.shape, b, dtype=complexity.dtype,
                          device=complexity.device)


class MonotoneDense(nn.Module):
    """x @ softplus(theta) + bias; theta is (in, out) as in the reference."""

    def __init__(self, in_features: int, features: int, gain: float = 0.5):
        super().__init__()
        self.gain = gain
        self.theta = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.full((features,), 0.1))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator):
        # softplus(theta) == max(|xavier_uniform(gain)|, 1e-4); fans of an
        # (in, out) kernel are (in, out), so initialize the transpose
        w = torch.empty(self.theta.shape[1], self.theta.shape[0])
        init.xavier_uniform_(w, self.gain, g, absolute=True)
        w = torch.clamp(w.t(), min=1e-4)
        self.theta.copy_(torch.log(torch.expm1(w)))
        self.bias.fill_(0.1)

    def forward(self, x):
        return x @ F.softplus(self.theta) + self.bias


class ComplexityToBitMappingNetwork(nn.Module):
    """Learnable complexity -> bits MLP (Eq.13-17).  BatchNorm uses its
    running statistics, or with `training` the batch's over the N = B*Ht*Wt
    tiles (and updates the running ones)."""

    def __init__(self, min_bits: int = 2, max_bits: int = 8,
                 hidden_dims=(32, 64, 32), monotone_param: str = "softplus"):
        super().__init__()
        if monotone_param not in ("softplus", "abs"):
            raise ValueError(f"unknown monotone_param {monotone_param!r}")
        self.min_bits, self.max_bits = min_bits, max_bits
        self.softplus = monotone_param == "softplus"
        dims = (3,) + tuple(hidden_dims) + (1,)
        for i in range(len(dims) - 1):
            layer = (MonotoneDense(dims[i], dims[i + 1]) if self.softplus
                     else nn.Linear(dims[i], dims[i + 1]))
            self.add_module(f"{self._dense_name}_{i}", layer)
        for i, d in enumerate(hidden_dims):
            # flax BatchNorm(momentum=0.9), eps 1e-5
            self.add_module(f"BatchNorm_{i}", BatchNorm1d(d, eps=1e-5, momentum=0.1))
        self.n_hidden = len(hidden_dims)

    @property
    def _dense_name(self):
        return "MonotoneDense" if self.softplus else "Dense"

    def _dense(self, i):
        return getattr(self, f"{self._dense_name}_{i}")

    @torch.no_grad()
    def init_weights(self, g: torch.Generator):
        if not self.softplus:  # MonotoneDense layers initialize themselves
            for i in range(self.n_hidden + 1):
                init.xavier_uniform_(self._dense(i).weight, 0.5, g, absolute=True)
                self._dense(i).bias.fill_(0.1)
        for i in range(self.n_hidden):
            getattr(self, f"BatchNorm_{i}").reset_parameters()

    def forward(self, complexity, temperature=None, return_continuous=False,
                training=False):
        c = torch.clamp(normalize_complexity_shape(complexity), 0.0, 1.0)
        B, H, W = c.shape
        z = c.reshape(-1, 1)
        h = torch.cat([z, z ** 2, torch.log1p(z)], dim=-1)
        for i in range(self.n_hidden):
            h = getattr(self, f"BatchNorm_{i}")(self._dense(i)(h), training)
            h = F.leaky_relu(h, 0.05) if self.softplus else F.relu(h)
        h = torch.sigmoid(self._dense(self.n_hidden)(h))
        bit_map = (self.min_bits + (self.max_bits - self.min_bits) * h).reshape(B, H, W)
        return _finalize_bit_map(bit_map, float(self.min_bits), float(self.max_bits),
                                 temperature, return_continuous)


@torch.no_grad()
def enforce_monotonic_params(mapper: nn.Module) -> nn.Module:
    """Eq.(18) |W| re-projection of the bit mapper, in place, after every
    optimizer step: the absolute value of every Dense kernel and BatchNorm
    scale (the reference matches the leaf names 'kernel' and 'scale').
    MonotoneDense's `theta` and all biases are left alone."""
    for m in mapper.modules():
        if isinstance(m, (nn.Linear, nn.BatchNorm1d)):
            m.weight.abs_()
    return mapper


def bit_histogram(bit_map: torch.Tensor, min_bits: int = 2, max_bits: int = 8) -> torch.Tensor:
    """int32 counts of each integer bit width min_bits..max_bits, after
    rounding and clipping; stays on the device."""
    b = torch.clamp(torch.round(bit_map.detach()), min_bits, max_bits).to(torch.int64)
    hist = torch.zeros(int(max_bits - min_bits + 1), dtype=torch.int32, device=b.device)
    return hist.index_add_(0, (b - min_bits).reshape(-1),
                           torch.ones(b.numel(), dtype=torch.int32, device=b.device))


def get_bit_statistics(bit_map: torch.Tensor, min_bits: int = 2, max_bits: int = 8) -> dict:
    """Mean, std (population), min, max and the integer-bit histogram of a
    bit map."""
    return {
        "mean": bit_map.mean(),
        "std": bit_map.std(correction=0),
        "min": bit_map.min(),
        "max": bit_map.max(),
        "histogram": bit_histogram(bit_map, min_bits, max_bits),
    }
