"""
Image primitives used by the morphology pipeline and the soft mask
(the subset of `mcaq_yolo_tpu/core/image_ops.py` the inference path runs).

Single-channel maps are (B, H, W), as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def replicate_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate pad the last two axes of (B, H, W)."""
    return F.pad(x[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k average pool of (B, H, W) (VALID)."""
    return F.avg_pool2d(x[:, None], k)[:, 0]


def normalize01(x: torch.Tensor) -> torch.Tensor:
    """Per-image min-max normalization of (B, H, W) to [0, 1]."""
    x_min = x.amin(dim=(1, 2), keepdim=True)
    x_max = x.amax(dim=(1, 2), keepdim=True)
    return (x - x_min) / (x_max - x_min + 1e-8)


def gaussian_kernel1d(k: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(k, dtype=torch.float32, device=device) - k // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def gaussian_blur_edge(x: torch.Tensor, k: int, sigma: float) -> torch.Tensor:
    """2-D (outer-product) Gaussian blur of (B, H, W) with edge-replicate
    padding — the reference's `gaussian_blur(..., mode='edge')`."""
    g1 = gaussian_kernel1d(k, sigma, x.device)
    g2 = (g1[:, None] * g1[None, :])[None, None]
    xp = F.pad(x[:, None].float(), (k // 2,) * 4, mode="replicate")
    return F.conv2d(xp, g2)[:, 0]


def upsample_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest upsample of (B, Ht, Wt) or (B, Ht, Wt, C) to (H, W).

    Exact tile multiples repeat; otherwise pixel i takes tile
    floor(i * Ht / H) (torch 'nearest' index semantics, the reference's
    rule at `mcaq_yolo_tpu/core/image_ops.py:177-195`)."""
    H, W = size
    Ht, Wt = x.shape[1], x.shape[2]
    if H % Ht == 0 and W % Wt == 0:
        return x.repeat_interleave(H // Ht, dim=1).repeat_interleave(W // Wt, dim=2)
    ri = torch.arange(H, device=x.device) * Ht // H
    ci = torch.arange(W, device=x.device) * Wt // W
    return x[:, ri][:, :, ci]


def tile_size_for(H: int, grid_size: int) -> int:
    """Largest power of two <= max(4, H // grid_size) (reference
    `image_ops.py:203-214`, including the tiny-map single-tile rule)."""
    raw = max(4, H // grid_size)
    tile = 1 << (raw.bit_length() - 1)
    if tile > H:
        tile = max(1, 1 << (H.bit_length() - 1))
    return tile


def spatial_weights(kernel_size: int, sigma: float):
    """Python-float spatial Gaussian weights of a k x k window, row-major
    over (dy, dx) — the bilateral filter's fixed part."""
    pad = kernel_size // 2
    return [math.exp(-(dy * dy + dx * dx) / (2.0 * sigma ** 2))
            for dy in range(-pad, pad + 1) for dx in range(-pad, pad + 1)]
