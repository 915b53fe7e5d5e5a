"""
The benchmark's yardsticks, frozen here so that no change to the program
moves them: the card's published peaks, the bytes and operations each
hand-written kernel must spend on a call, and the network's FLOPs.

  * peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity);
  * `quant_bytes`, `QUANT_OPS_PER_ELEMENT`, `bound_s`:
    `mcaq_yolo_tpu_torch/utils/cuda_timing.py` at commit 00c80e2;
  * `phi_tiles_ops`, `phi_tiles_bytes`, `PHI_OPS_PER_PIXEL`:
    `mcaq_yolo_tpu_torch/core/morphology_lanes.py` at commit 00c80e2
    (the deployed options: cv2-compatible Canny, adaptive binarization,
    Euler-corrected contours);
  * FLOPs: 2 x multiply-accumulates of every convolution of the
    reference network (`reference.network.conv_flops`), the rule of
    `mcaq_yolo_tpu_torch/utils/profiling.py:KernelFloorMode` at 00c80e2; a
    training step counts the student's forward once and its backward twice
    (input and weight gradients), plus the teacher's forward.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_FLOPS = 989e12

QUANT_OPS_PER_ELEMENT = 8  # divide, add, rint, 2 clamps, subtract, multiply, mask multiply
PHI_OPS_PER_PIXEL = {
    "phi3_sobel": 26, "canny_cv2compat": 148, "binarize_adaptive": 45, "lbp": 42,
    "contour": 12, "euler": 16, "box_counts": 2, "edge_density": 1,
}


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes at the HBM rate or float32
    operations at the CUDA-core rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def quant_bytes(B: int, H: int, W: int, C: int, elem: int, Ht: int, Wt: int,
                mask: bool = True) -> int:
    """x read once and the output written once, the bit map, the
    per-channel range and the mask read once."""
    n = 2 * B * H * W * C * elem + B * Ht * Wt * 4 + 2 * C * 4
    return n + (B * H * W * 4 if mask else 0)


def quant_ops(B: int, H: int, W: int, C: int) -> int:
    return B * H * W * C * QUANT_OPS_PER_ELEMENT


def phi_tiles_ops(gray_numel: int) -> int:
    return sum(PHI_OPS_PER_PIXEL.values()) * gray_numel


def phi_tiles_bytes(B: int, Hg: int, Wg: int, tile: int) -> int:
    """The gray map read once, phi (8 floats a tile) written once."""
    return B * Hg * Wg * 4 + B * (Hg // tile) * (Wg // tile) * 8 * 4


def scale_shapes(img: int, variant: str, grid: int, downsample: int) -> List[Dict]:
    """Per scale of the MCAQ transform: the feature map (H, W, C), the tile
    grid (Ht, Wt) and the gray map (Hg, Wg, tile) the phi kernel reads."""
    from .reference.mcaq import gray_geometry, tile_size_for
    from .reference.network import STRIDES, variant_channels

    out = []
    for s, C in zip(STRIDES, variant_channels(variant)):
        H = W = img // s
        t0 = tile_size_for(H, grid)
        Hc, Wc, ds, tile = gray_geometry(H, W, grid, downsample)
        out.append({"H": H, "W": W, "C": C, "Ht": H // t0, "Wt": W // t0,
                    "Hg": Hc // ds, "Wg": Wc // ds, "tile": tile})
    return out


def serve_bounds(B: int, img: int, variant: str, grid: int, downsample: int,
                 elem: int = 2) -> Tuple[float, float]:
    """(quantize, phi) least seconds of one deployed call of batch B."""
    q = p = 0.0
    for sh in scale_shapes(img, variant, grid, downsample):
        q += bound_s(quant_bytes(B, sh["H"], sh["W"], sh["C"], elem, sh["Ht"], sh["Wt"]),
                     quant_ops(B, sh["H"], sh["W"], sh["C"]))
        numel = B * sh["Hg"] * sh["Wg"]
        p += bound_s(phi_tiles_bytes(B, sh["Hg"], sh["Wg"], sh["tile"]), phi_tiles_ops(numel))
    return q, p


def network_flops(variant: str, nc: int, img: int) -> int:
    """FLOPs of one image through the network (backbone, neck, head)."""
    from .reference.network import YOLOv8

    with torch.device("meta"):
        net = YOLOv8(variant, nc)
        x = torch.empty((1, 3, img, img))

        class Body(torch.nn.Module):
            def __init__(self, n):
                super().__init__()
                self.n = n

            def forward(self, x):
                return self.n.head(self.n.neck(*self.n.backbone(x)))

        from .reference.network import conv_flops
        return conv_flops(Body(net), x)


def train_flops_per_image(variant: str, nc: int, img: int) -> int:
    """Student forward + backward (x 3) and the teacher's forward."""
    return 4 * network_flops(variant, nc, img)
