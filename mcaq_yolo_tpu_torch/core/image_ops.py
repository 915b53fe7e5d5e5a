"""
Image primitives used by the morphology pipeline and the soft mask (port
of `mcaq_yolo_tpu/core/image_ops.py`).

Single-channel maps are (B, H, W), as in the reference; H and W need not
be equal.  The whole-image operators (`conv2d_*`, `gaussian_blur`,
`sobel`, `max_pool`, the histogram Otsu) serve the 'global' metric mode;
the per-tile mode has its own shift-add operators in `morphology.py`.
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


def max_pool(x: torch.Tensor, k: int, stride: int = None, pad: int = 0) -> torch.Tensor:
    """Max pool over the last two axes of (B, H, W); the padding never
    wins (-inf), as `lax.reduce_window` pads."""
    return F.max_pool2d(x[:, None], k, stride or k, pad)[:, 0]


def _conv_single(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """VALID cross-correlation of (B, H, W) with a (kh, kw) kernel in full
    float32: cuDNN's TF32 is off for the call (its 10-bit inputs would move
    the Otsu thresholds and the edges); its other flags stay as they are."""
    k = kernel.to(device=x.device, dtype=torch.float32)[None, None]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x[:, None].to(torch.float32), k)[:, 0]


def conv2d_replicate(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME conv with edge-replicate padding (cv2's default border mode)."""
    kh, kw = kernel.shape
    xp = F.pad(x[:, None], (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")[:, 0]
    return _conv_single(xp, kernel)


def conv2d_zero(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME conv with zero padding."""
    kh, kw = kernel.shape
    return _conv_single(F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2)), kernel)


def normalize01(x: torch.Tensor) -> torch.Tensor:
    """Per-image min-max normalization of (B, H, W) to [0, 1]."""
    x_min = x.amin(dim=(1, 2), keepdim=True)
    x_max = x.amax(dim=(1, 2), keepdim=True)
    return (x - x_min) / (x_max - x_min + 1e-8)


def gaussian_kernel1d(k: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(k, dtype=torch.float32, device=device) - k // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def gaussian_blur(x: torch.Tensor, k: int, sigma: float, mode: str = "zero") -> torch.Tensor:
    """Gaussian blur of (B, H, W) with the k x k outer-product kernel, edge
    or zero padded."""
    g1 = gaussian_kernel1d(k, sigma, x.device)
    g2 = g1[:, None] * g1[None, :]
    return conv2d_replicate(x, g2) if mode == "edge" else conv2d_zero(x, g2)


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel(gray: torch.Tensor, mode: str = "zero"):
    """3x3 Sobel gradients of (B, H, W) as one non-separable conv each;
    mode 'zero' pads zeros, 'edge' replicates the border."""
    conv = conv2d_replicate if mode == "edge" else conv2d_zero
    return (conv(gray, torch.tensor(_SOBEL_X, device=gray.device)),
            conv(gray, torch.tensor(_SOBEL_Y, device=gray.device)))


def histogram01(x: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Per-row histogram of (B, N) values in [0, 1] -> (B, bins) float32
    counts (exact below 2^24 per bin)."""
    idx = torch.clamp((x * bins).to(torch.int32), 0, bins - 1).to(torch.int64)
    hist = torch.zeros((x.shape[0], bins), dtype=torch.float32, device=x.device)
    return hist.scatter_add_(1, idx, torch.ones(idx.shape, dtype=torch.float32,
                                                device=x.device))


def otsu_threshold(x: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Per-image Otsu threshold of (B, H, W) in [0, 1] -> (B, 1, 1): the
    bin center maximizing sigma_b = (mu_T omega - mu)^2 / (omega (1 -
    omega)) over a 256-bin histogram, first bin on ties."""
    B = x.shape[0]
    hist = histogram01(x.reshape(B, -1), bins)
    centers = (torch.arange(bins, dtype=torch.float32, device=x.device) + 0.5) / bins
    p = hist / torch.clamp(hist.sum(dim=1, keepdim=True), min=1.0)
    omega = torch.cumsum(p, dim=1)
    mu = torch.cumsum(p * centers[None, :], dim=1)
    mu_t = mu[:, -1:]
    sigma_b = (mu_t * omega - mu) ** 2 / (omega * (1.0 - omega) + 1e-12)
    return centers[torch.argmax(sigma_b, dim=1)].reshape(B, 1, 1)


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
