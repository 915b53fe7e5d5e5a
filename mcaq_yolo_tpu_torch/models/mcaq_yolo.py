"""
MCAQ-YOLO assembly (port of `mcaq_yolo_tpu/models/mcaq_yolo.py:36-171`):
YOLOv8 with tile-wise mixed-precision quantization of the backbone's
C3/C4/C5 outputs before the neck.  One complexity analyzer and one bit
mapper are shared across scales; each scale has its own quantizer (own
channel count, own soft mask).

`forward(training=True)` is the training forward: BatchNorm on batch
statistics, continuous bit maps, the quantizers' fractional compose with
their EMA step, with autograd.  `training=False` is the eval forward
(integer bits, the CUDA kernel on CUDA), without gradient.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ..core.bit_allocation import (
    ComplexityToBitMappingNetwork,
    ConstantBitMapper,
    LinearBitMapper,
    percentile_normalize,
)
from ..core.morphology import MorphologicalComplexityAnalyzer
from ..core.quantization import SpatialAdaptiveQuantization
from ..device import DeviceLike, resolve_device
from .yolo import (
    DetectHead,
    YOLOv8Backbone,
    YOLOv8Neck,
    images_to_nchw,
    init_weights,
    set_network_dtype,
    variant_channels,
)


class MCAQYOLO(nn.Module):
    """forward(x (B, H, W, 3) uint8 or float, temperature, quantize) ->
    (raw_maps [3 x (B, H_s, W_s, 4*REG_MAX + nc) float32], aux dict).

    aux: 'complexity_map' and 'bit_map' (per-scale (B, Ht, Wt) lists),
    'avg_bits' (mean over scales of each scale's tile mean),
    'quantized_features' (per-scale NHWC), 'feature_layers'.

    `dtype` is the network's compute dtype (bfloat16 on the deployed path;
    the convolution weights are cast once).  For bfloat16 training keep
    float32 and run the forward under `torch.autocast`: the MCAQ transform
    turns autocast off, so the MCAQ math always runs in float32, and the
    quantizer returns the feature's dtype.  `quant_backend`: 'auto' = the
    CUDA kernel on CUDA tensors and its plain version on the CPU; 'torch' =
    always the plain version.
    The model is built on `device` (default CUDA; raises without one) with
    a seeded random init, in eval mode."""

    def __init__(self, variant: str = "yolov8n", num_classes: int = 80,
                 min_bits: int = 2, max_bits: int = 8, target_bits: float = 4.0,
                 grid_size: int = 8, bit_mapping: str = "mlp",
                 constant_bits: float = 4.0, monotone_param: str = "softplus",
                 normalize_complexity: bool = False, calibration_mode: str = "minmax",
                 smooth_transitions: bool = True, quant_backend: str = "auto",
                 morph_downsample: int = 1, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.variant, self.num_classes = variant, num_classes
        self.min_bits, self.max_bits, self.target_bits = min_bits, max_bits, target_bits
        self.grid_size, self.bit_mapping = grid_size, bit_mapping
        self.monotone_param = monotone_param
        self.normalize_complexity = normalize_complexity
        self.morph_downsample = morph_downsample
        self.dtype = dtype

        self.backbone = YOLOv8Backbone(variant)
        self.neck = YOLOv8Neck(variant)
        self.head = DetectHead(num_classes, variant)
        self.complexity_analyzer = MorphologicalComplexityAnalyzer(
            grid_size=grid_size, downsample=morph_downsample)
        if bit_mapping == "constant":
            self.bit_mapper = ConstantBitMapper(constant_bits, min_bits, max_bits)
        elif bit_mapping == "linear":
            self.bit_mapper = LinearBitMapper(min_bits, max_bits)
        elif bit_mapping == "mlp":
            self.bit_mapper = ComplexityToBitMappingNetwork(
                min_bits, max_bits, hidden_dims=(32, 64, 32),
                monotone_param=monotone_param)
        else:
            raise ValueError(f"unknown bit_mapping {bit_mapping!r}")
        for i, c in enumerate(variant_channels(variant)):
            self.add_module(f"quantizer_p{i + 3}", SpatialAdaptiveQuantization(
                c, calibration_mode=calibration_mode,
                smooth_transitions=smooth_transitions, backend=quant_backend))

        init_weights(self, seed)
        set_network_dtype(self.backbone, self.neck, self.head, dtype=dtype)
        self.to(device=device, memory_format=torch.channels_last)
        self.eval()

    @property
    def quantizers(self) -> List[SpatialAdaptiveQuantization]:
        return [getattr(self, f"quantizer_p{i + 3}") for i in range(3)]

    def set_quant_backend(self, backend: str) -> None:
        if backend not in ("auto", "torch"):
            raise ValueError(f"unknown quantizer backend {backend!r}")
        for q in self.quantizers:
            q.backend = backend

    def mcaq_transform(self, feat: torch.Tensor, scale_idx: int, temperature: float,
                       quantize: bool, training: bool = False,
                       update_stats: Optional[bool] = None):
        """feat NCHW channels_last -> (feat_q NCHW, complexity, bit_map).
        Continuous bits with `training`; `quantize=False` (curriculum
        Stage 1) still runs the analyzer and the mapper."""
        with torch.autocast(feat.device.type, enabled=False):
            f = feat.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            complexity = self.complexity_analyzer(f)
            if self.normalize_complexity:
                complexity = percentile_normalize(complexity)
            bit_map = self.bit_mapper(complexity, temperature, return_continuous=training,
                                      training=training)
            fq = f
            if quantize:
                fq = self.quantizers[scale_idx](f, bit_map, training=training,
                                                update_stats=update_stats)
        return fq.permute(0, 3, 1, 2), complexity, bit_map

    def forward(self, x: torch.Tensor, temperature: float = 1.0, quantize: bool = True,
                training: bool = False, update_stats: Optional[bool] = None):
        """`update_stats` (default: `training`): the quantizers take one EMA
        step of their running min/max (calibration passes True with
        training=False).  Without `training` no gradient is recorded."""
        with contextlib.nullcontext() if training else torch.no_grad():
            feats = self.backbone(images_to_nchw(x, self.dtype), training)
            feats_q, complexity_maps, bit_maps = [], [], []
            for i, f in enumerate(feats):
                fq, c, b = self.mcaq_transform(f, i, temperature, quantize, training,
                                               update_stats)
                feats_q.append(fq)
                complexity_maps.append(c)
                bit_maps.append(b)
            raw_maps = self.head(self.neck(*feats_q, training), training)
        avg_bits = torch.stack([b.to(torch.float32).mean() for b in bit_maps]).mean()
        aux: Dict = {
            "complexity_map": complexity_maps,
            "bit_map": bit_maps,
            "avg_bits": avg_bits,
            "quantized_features": [f.permute(0, 2, 3, 1) for f in feats_q],
            "feature_layers": [4, 6, 9],
        }
        return raw_maps, aux

    def backbone_features(self, x: torch.Tensor, training: bool = False):
        """Unquantized backbone features (C3, C4, C5), NCHW channels_last:
        the student-side taps for feature-level distillation."""
        return self.backbone(images_to_nchw(x, self.dtype), training)
