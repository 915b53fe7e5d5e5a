"""
Serving export (port of `mcaq_yolo_tpu/export.py`): the deployed inference
program as a `torch.export` artifact, in place of the reference's
jax.export / StableHLO serialization.

The spatial quantizer is the registered op `mcaq::spatial_quantize`
(`ops/spatial_quant.py`) and the per-tile phi engine the op `mcaq::phi_tiles`
(`core/morphology_lanes.py`, with the model's default 'lanes' engine), so
the exported graph carries each as a node, three per forward, as the
reference's StableHLO carries its quantizer: on CUDA the loaded program
launches the hand-written kernels.  A model exported on CUDA also carries
each ConvBnSiLU's eval BatchNorm + SiLU as a node of the op `mcaq::bn_silu`
(`ops/bn_silu.py`; on the CPU they stay `batch_norm` and `silu`).
Importing this module registers the three ops, so a fresh process can load
a saved artifact.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch
import torch.nn as nn

from .core import morphology_lanes  # noqa: F401  (registers mcaq::phi_tiles)
from .models.mcaq_yolo import MCAQYOLO
from .models.yolo import decode_and_nms
from .ops import bn_silu, spatial_quant  # noqa: F401  (register mcaq::bn_silu, ::spatial_quantize)

ARTIFACT = "mcaq_yolo.pt2"
GRAPH_TEXT = "mcaq_yolo.graph.txt"


def make_inference_fn(model: MCAQYOLO, with_nms: bool = True, conf_threshold: float = 0.25,
                      iou_threshold: float = 0.45, max_det: int = 300):
    """The deployable program: the quantized forward at temperature 1.0,
    plus the fused `decode_and_nms` (the program `Predictor` and
    `make_eval_step` run).  images (B, H, W, 3) ->
    (boxes, scores, classes, valid, avg_bits), or without NMS
    (raw maps..., avg_bits)."""

    def fn(images: torch.Tensor):
        raw, aux = model(images, temperature=1.0, quantize=True, training=False)
        if not with_nms:
            return tuple(raw) + (aux["avg_bits"],)
        det = decode_and_nms(raw, model.num_classes, conf_threshold=conf_threshold,
                             iou_threshold=iou_threshold, max_det=max_det)
        return tuple(det) + (aux["avg_bits"],)

    return fn


class _Serving(nn.Module):
    """`make_inference_fn(model)` as a module, so the weights are the
    program's own state."""

    def __init__(self, model: MCAQYOLO, with_nms: bool):
        super().__init__()
        self.model = model
        self.fn = make_inference_fn(model, with_nms)

    def forward(self, images: torch.Tensor):
        return self.fn(images)


def export_inference(model: MCAQYOLO, batch_size: int = 1, img_size: int = 640,
                     with_nms: bool = True) -> torch.export.ExportedProgram:
    """`torch.export` of the inference program on the model's device for a
    static float32 (batch_size, img_size, img_size, 3) input in [0, 1]
    (the reference's x_spec), with the weights closed over."""
    device = next(model.parameters()).device
    x = torch.zeros((batch_size, img_size, img_size, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        return torch.export.export(_Serving(model, with_nms).eval(), (x,))


def save_exported(model: MCAQYOLO, out_dir, batch_size: int = 1, img_size: int = 640,
                  with_nms: bool = True) -> Dict[str, str]:
    """Write <out_dir>/mcaq_yolo.pt2 (`torch.export.save`) and the readable
    graph <out_dir>/mcaq_yolo.graph.txt; returns both paths.  Replaces the
    reference's `save_stablehlo` (`.stablehlo` + `.mlir.txt`)."""
    exported = export_inference(model, batch_size, img_size, with_nms)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    blob = out / ARTIFACT
    torch.export.save(exported, str(blob))
    text = out / GRAPH_TEXT
    text.write_text(str(exported.graph_module.code))
    return {"serialized": str(blob), "graph": str(text)}


def load_exported(path):
    """A saved artifact as a callable: program(images) -> the outputs of
    `make_inference_fn`, on the device it was exported on."""
    return torch.export.load(str(path)).module()


def _count_nodes(exported: torch.export.ExportedProgram, op) -> int:
    return sum(1 for n in exported.graph.nodes if n.op == "call_function" and n.target is op)


def count_quant_nodes(exported: torch.export.ExportedProgram) -> int:
    """How many `mcaq::spatial_quantize` nodes an exported graph holds."""
    return _count_nodes(exported, torch.ops.mcaq.spatial_quantize.default)


def count_phi_nodes(exported: torch.export.ExportedProgram) -> int:
    """How many `mcaq::phi_tiles` nodes an exported graph holds."""
    return _count_nodes(exported, torch.ops.mcaq.phi_tiles.default)


def count_bn_silu_nodes(exported: torch.export.ExportedProgram) -> int:
    """How many `mcaq::bn_silu` nodes an exported graph holds."""
    return _count_nodes(exported, torch.ops.mcaq.bn_silu.default)
