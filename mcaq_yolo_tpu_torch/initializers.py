"""Seeded parameter initializers matching the reference's flax defaults in
distribution (not in bits: torch.Generator and jax.random draw different
numbers from the same seed).  Every function takes an explicit
torch.Generator and fills a tensor in place.

Shapes follow torch (Conv2d weight OIHW, Linear weight (out, in)); fans are
computed the way flax computes them on its own layouts, so the variances
agree with the reference's initializers."""

from __future__ import annotations

import math

import torch

# flax lecun_normal = variance_scaling(1, fan_in, truncated_normal): the
# truncated (+-2 sigma) normal is rescaled by this factor to keep variance 1
_TRUNC_STD = 0.87962566103423978


def _fans(t: torch.Tensor):
    if t.dim() == 2:  # Linear (out, in)
        return t.shape[1], t.shape[0]
    receptive = math.prod(t.shape[2:])  # Conv OIHW
    return t.shape[1] * receptive, t.shape[0] * receptive


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    fan_in, _ = _fans(t)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    tmp = torch.empty(t.shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=g)
    return t.copy_(tmp * std)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, gain: float, g: torch.Generator,
                    absolute: bool = False) -> torch.Tensor:
    """variance_scaling(gain^2, fan_avg, uniform); |.| when `absolute`."""
    fan_in, fan_out = _fans(t)
    limit = math.sqrt(3.0 * gain * gain / ((fan_in + fan_out) / 2.0))
    tmp = torch.empty(t.shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=g)
    return t.copy_(tmp.abs() if absolute else tmp)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> torch.Tensor:
    tmp = torch.empty(t.shape, dtype=torch.float32).normal_(0.0, std, generator=g)
    return t.copy_(tmp)
