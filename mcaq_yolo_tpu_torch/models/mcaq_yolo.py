"""
MCAQ-YOLO assembly (port of `mcaq_yolo_tpu/models/mcaq_yolo.py:36-171`):
a YOLOv8, YOLO11, YOLO12 or RT-DETR (`models/yolo.py` families) with tile-wise
mixed-precision quantization of the backbone's C3/C4/C5 outputs before the
neck.  One complexity analyzer and one bit mapper are shared across scales;
each scale has its own quantizer (own channel count, own soft mask).

`forward(training=True)` is the training forward: BatchNorm on batch
statistics, continuous bit maps, the quantizers' fractional compose with
their EMA step, with autograd.  `training=False` is the eval forward
(integer bits, the CUDA kernel on CUDA), without gradient.

Under data parallelism (`parallel.mesh.reduced_over(group, model)`) the
forward takes this rank's slice of the global batch and its batch-wide
reductions run over the group: the BatchNorm training statistics, the
quantizers' ranges, and `avg_bits`, the global mean (differentiable: it
feeds the squared bit-budget loss, and a mean of squares is not the
square of the mean).
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
from ..core.morphology import TILE_ENGINES, MorphologicalComplexityAnalyzer
from ..core.quantization import SpatialAdaptiveQuantization
from ..device import DeviceLike, resolve_device
from ..parallel.mesh import all_mean
from ..utils.profiling import span
from .yolo import (
    FEATURE_LAYERS,
    build_network,
    family,
    images_to_nchw,
    init_weights,
    set_network_dtype,
    variant_channels,
)


class MCAQYOLO(nn.Module):
    """forward(x (B, H, W, 3) uint8 or float, temperature, quantize) ->
    (raw, aux dict).  raw: the Detect head's maps [3 x (B, H_s, W_s,
    4*REG_MAX + nc) float32] (YOLO), or RT-DETR's decoder output [boxes
    (B, 300, 4) cx, cy, w, h in [0, 1], logits (B, 300, nc)] float32.

    aux: 'complexity_map' and 'bit_map' (per-scale (B, Ht, Wt) lists),
    'avg_bits' (mean over scales of each scale's tile mean),
    'quantized_features' (per-scale NHWC), 'feature_layers' (the family's
    backbone layers tapped: [4, 6, 9] YOLOv8, [4, 6, 10] YOLO11, [4, 6, 8]
    YOLO12, [3, 7, 9] RT-DETR).

    `dtype` is the network's compute dtype (bfloat16 on the deployed path;
    the convolution weights are cast once).  For bfloat16 training keep
    float32 and run the forward under `torch.autocast`: the MCAQ transform
    turns autocast off, so the MCAQ math always runs in float32, and the
    quantizer returns the feature's dtype.  `quant_backend` picks the eval
    quantize: 'auto' = the CUDA kernel on CUDA tensors and its plain version
    on the CPU; 'torch' = always the plain version.  Training always runs
    `ops/frac_quant.py:frac_quantize` (the kernel pair on the card).
    The model is built on `device` (default CUDA; raises without one) with
    a seeded random init, in eval mode.  `morph_tile_engine` is the
    analyzer's tile engine: 'lanes' (the default) computes phi with the
    hand-written CUDA kernel on the card, 'rows' with the plain PyTorch ops;
    both run the plain ops on the CPU (`core/morphology.py`)."""

    data_group = None  # the process group of the data-parallel batch

    def __init__(self, variant: str = "yolov8n", num_classes: int = 80,
                 min_bits: int = 2, max_bits: int = 8, target_bits: float = 4.0,
                 grid_size: int = 8, bit_mapping: str = "mlp",
                 constant_bits: float = 4.0, monotone_param: str = "softplus",
                 normalize_complexity: bool = False, calibration_mode: str = "minmax",
                 smooth_transitions: bool = True, quant_backend: str = "auto",
                 morph_downsample: int = 1, morph_tile_engine: str = "lanes",
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        if morph_tile_engine not in TILE_ENGINES:
            raise ValueError(f"morph_tile_engine must be one of {TILE_ENGINES}, "
                             f"got {morph_tile_engine!r}")
        self.family = family(variant)
        self.feature_layers = FEATURE_LAYERS[self.family]
        device = resolve_device(device)
        self.variant, self.num_classes = variant, num_classes
        self.min_bits, self.max_bits, self.target_bits = min_bits, max_bits, target_bits
        self.grid_size, self.bit_mapping = grid_size, bit_mapping
        self.monotone_param = monotone_param
        self.normalize_complexity = normalize_complexity
        self.morph_downsample = morph_downsample
        self.morph_tile_engine = morph_tile_engine
        self.dtype = dtype

        self.backbone, self.neck, self.head = build_network(variant, num_classes)
        self.complexity_analyzer = MorphologicalComplexityAnalyzer(
            grid_size=grid_size, downsample=morph_downsample, tile_engine=morph_tile_engine)
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
                       update_stats: Optional[bool] = None,
                       bit_map: Optional[torch.Tensor] = None):
        """feat NCHW channels_last -> (feat_q NCHW, complexity, bit_map).
        Continuous bits with `training`; `quantize=False` (curriculum
        Stage 1) still runs the analyzer and the mapper.  A given `bit_map`
        (B, Ht, Wt) replaces the analyzer and the mapper (complexity None).
        Spans 'mcaq.analyzer', 'mcaq.mapper', 'mcaq.quantize' (attribute
        `scale`: 3, 4, 5 for P3-P5)."""
        # the MCAQ math runs in float32 even under a bf16 autocast (training);
        # without autocast no context is entered, so torch.export traces plain ops
        autocast = torch.is_autocast_enabled(feat.device.type)
        with torch.autocast(feat.device.type, enabled=False) if autocast \
                else contextlib.nullcontext():
            f = feat.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            complexity = None
            scale = scale_idx + 3
            if bit_map is None:
                with span("mcaq.analyzer", scale=scale):
                    complexity = self.complexity_analyzer(f)
                    if self.normalize_complexity:
                        complexity = percentile_normalize(complexity)
                with span("mcaq.mapper", scale=scale):
                    bit_map = self.bit_mapper(complexity, temperature,
                                              return_continuous=training, training=training)
            fq = f
            if quantize:
                with span("mcaq.quantize", scale=scale):
                    fq = self.quantizers[scale_idx](f, bit_map, training=training,
                                                    update_stats=update_stats)
        return fq.permute(0, 3, 1, 2), complexity, bit_map

    def forward(self, x: torch.Tensor, temperature: float = 1.0, quantize: bool = True,
                training: bool = False, update_stats: Optional[bool] = None):
        """`update_stats` (default: `training`): the quantizers take one EMA
        step of their running min/max (calibration passes True with
        training=False).  Without `training` no gradient is recorded."""
        return self._forward(x, temperature, quantize, training, update_stats)

    def forward_with_bit_maps(self, x: torch.Tensor, bit_maps: List[torch.Tensor],
                              training: bool = False) -> List[torch.Tensor]:
        """The quantized forward with externally supplied per-scale bit maps
        [(B, Ht, Wt)] in place of the analyzer's and mapper's: the raw maps
        only.  Everything else is `forward`'s code, so the model's own maps
        give `forward(x, quantize=True)`'s raw maps bitwise."""
        return self._forward(x, 1.0, True, training, None, bit_maps)[0]

    def _forward(self, x, temperature, quantize, training, update_stats, given_maps=None):
        no_grad = not training and torch.is_grad_enabled()
        with torch.no_grad() if no_grad else contextlib.nullcontext():
            with span("model.backbone"):
                feats = self.backbone(images_to_nchw(x, self.dtype), training)
            feats_q, complexity_maps, bit_maps = [], [], []
            for i, f in enumerate(feats):
                fq, c, b = self.mcaq_transform(
                    f, i, temperature, quantize, training, update_stats,
                    None if given_maps is None else given_maps[i])
                feats_q.append(fq)
                complexity_maps.append(c)
                bit_maps.append(b)
            with span("model.neck"):
                necked = self.neck(*feats_q, training)
            with span("model.head"):
                raw_maps = self.head(necked, training)
            del necked   # freed as the head returns, as without the spans
        avg_bits = all_mean(torch.stack([b.to(torch.float32).mean() for b in bit_maps]).mean(),
                            self.data_group)
        aux: Dict = {
            "complexity_map": complexity_maps,
            "bit_map": bit_maps,
            "avg_bits": avg_bits,
            "quantized_features": [f.permute(0, 2, 3, 1) for f in feats_q],
            "feature_layers": list(self.feature_layers),
        }
        return raw_maps, aux

    def score_image(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic Eq.(8) per-image complexity of the input image
        (Algorithm 3 line 1): the offline dataset-scoring entry.  x (B, H, W,
        3) uint8 or float in [0, 1] -> (B,)."""
        return self.complexity_analyzer.score_image(x)

    def backbone_features(self, x: torch.Tensor, training: bool = False):
        """Unquantized backbone features (C3, C4, C5), NCHW channels_last:
        the student-side taps for feature-level distillation."""
        return self.backbone(images_to_nchw(x, self.dtype), training)
