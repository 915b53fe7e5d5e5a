"""
Model statistics and profiling (port of `mcaq_yolo_tpu/utils/model_utils.py`):
the tolerant checkpoint restore the Predictor and the scripts use, parameter counts and
size, steady-state throughput, per-channel post-training weight
fake-quantization, and activation-range collection.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..core.bit_allocation import MonotoneDense
from ..core.quantization import quantize_tensor
from ..models.weights_io import COLLECTIONS, load_jax_variables, to_jax_variables
from .checkpoint import load_checkpoint


def tolerant_restore(template: Dict, ckpt_path, collections=COLLECTIONS,
                     warn: bool = True) -> Dict:
    """Structure-free restore of a flax msgpack checkpoint into a flax-layout
    template (`weights_io.to_jax_variables(model)`): keys absent from the
    checkpoint, or with another shape, keep the template's value, with a
    warning; keys only the checkpoint has (an optimizer state, an entropy
    histogram the template lacks) are left out.  Returns numpy trees, one
    per collection, for `weights_io.load_jax_variables`."""
    payload = load_checkpoint(ckpt_path)

    def overlay(dst: Dict, src: Optional[Dict], path: str = "") -> Dict:
        out = dict(dst)
        for k, v in dst.items():
            if src is None or k not in src:
                if warn:
                    warnings.warn(f"[MCAQ] checkpoint missing {path}/{k}; "
                                  "keeping initialized value")
                continue
            if isinstance(v, dict):
                out[k] = overlay(v, src[k], f"{path}/{k}")
            elif tuple(np.shape(src[k])) == tuple(v.shape):
                out[k] = np.asarray(src[k], v.dtype)
            elif warn:
                warnings.warn(f"[MCAQ] shape mismatch at {path}/{k} ({np.shape(src[k])} vs "
                              f"{v.shape}); keeping initialized value")
        return out

    return {k: overlay(template.get(k, {}), payload.get(k)) for k in collections}


def restore_into(model: nn.Module, ckpt_path, warn: bool = True) -> nn.Module:
    """`tolerant_restore` of a checkpoint into `model` itself, in place:
    leaves the checkpoint lacks keep the model's values.  Returns the model."""
    template = to_jax_variables(model)
    restored = tolerant_restore(template, ckpt_path, warn=warn)
    load_jax_variables(model, {c: restored[c] for c in COLLECTIONS if c in template})
    return model


def count_parameters(model: nn.Module) -> Dict[str, int]:
    """Total and per-top-level-module parameter counts."""
    out = {"total": 0}
    for name, p in model.named_parameters():
        out["total"] += p.numel()
        top = name.split(".")[0]
        out[top] = out.get(top, 0) + p.numel()
    return out


def get_model_size(model: nn.Module, bits_per_param: float = 32.0) -> float:
    """Model size in MB at the given weight precision."""
    return count_parameters(model)["total"] * bits_per_param / 8.0 / 1e6


def profile_model(forward_fn: Callable, example_input, num_iters: int = 100,
                  warmup: int = 5) -> Dict[str, float]:
    """Steady-state timing of `forward_fn(example_input)`: on CUDA, CUDA
    events around `num_iters` back-to-back calls (the device time the calls
    take, their host enqueue overlapped); on the CPU, the host clock."""
    cuda = isinstance(example_input, torch.Tensor) and example_input.is_cuda
    for _ in range(warmup):
        forward_fn(example_input)
    if cuda:
        torch.cuda.synchronize(example_input.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(num_iters):
            forward_fn(example_input)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(num_iters):
            forward_fn(example_input)
        dt = time.perf_counter() - t0
    batch = example_input.shape[0] if hasattr(example_input, "shape") else 1
    return {"total_s": dt, "iter_ms": dt / num_iters * 1000.0, "fps": num_iters * batch / dt}


@torch.no_grad()
def apply_weight_quantization(model: nn.Module, bits: int = 8,
                              per_channel: bool = True) -> nn.Module:
    """Post-training fake quantization of every weight with two or more
    axes (biases and norms stay), in place.  Per channel means per output
    channel: dim 0 of a Conv2d (OIHW) or Linear (out, in) weight, the last
    axis of a MonotoneDense theta (in, out) — the reference's last axis of
    HWIO / (in, out) kernels."""
    for m in model.modules():
        for name, p in m.named_parameters(recurse=False):
            if p.dim() < 2:
                continue
            w = p.to(torch.float32)
            if per_channel:
                out_axis = p.dim() - 1 if isinstance(m, MonotoneDense) else 0
                axes = tuple(a for a in range(p.dim()) if a != out_axis)
                x_min, x_max = w.amin(dim=axes, keepdim=True), w.amax(dim=axes, keepdim=True)
            else:
                x_min, x_max = w.min(), w.max()
            p.copy_(quantize_tensor(w, x_min, x_max, bits, training=False))
    return model


@torch.no_grad()
def calibrate_activation_ranges(apply_feats_fn: Callable, batches,
                                max_batches: int = 8) -> Dict[str, Dict[str, float]]:
    """Activation min / max over calibration batches: apply_feats_fn(batch)
    returns a dict or a list of named feature maps."""
    ranges: Dict[str, Dict[str, float]] = {}
    for i, batch in enumerate(batches):
        feats = apply_feats_fn(batch)
        if not isinstance(feats, dict):
            feats = {f"feat{j}": f for j, f in enumerate(feats)}
        for name, f in feats.items():
            lo, hi = float(torch.min(f)), float(torch.max(f))
            if name not in ranges:
                ranges[name] = {"min": lo, "max": hi}
            else:
                ranges[name]["min"] = min(ranges[name]["min"], lo)
                ranges[name]["max"] = max(ranges[name]["max"], hi)
        if i + 1 >= max_batches:
            break
    return ranges
