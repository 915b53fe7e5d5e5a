"""
Weight bridge between the reference's flax variable tree and the port's
modules.

`load_jax_variables(model, variables)` takes the flax tree as nested dicts
of numpy arrays with the collections 'params', 'batch_stats',
'quant_stats' and 'buffers' (what `flax.serialization.msgpack_restore` or
`utils.checkpoint.read_msgpack` returns).  The port's submodules carry the
flax scope names, so a leaf at params/backbone/C2f_0/ConvBnSiLU_0/Conv_0/
kernel lands on `model.backbone.C2f_0.ConvBnSiLU_0.Conv_0.weight`:

  Conv  kernel HWIO -> weight OIHW; bias
  Dense kernel (in, out) -> Linear weight (out, in); bias
  BatchNorm / LayerNorm scale, bias -> weight, bias;
  batch_stats mean, var -> running_mean, running_var
  MonotoneDense theta stays (in, out)
  quant_stats / buffers -> the module buffer of the same name

`to_jax_variables(model)` is the inverse (float32 arrays, int32
num_batches, bool frozen).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.bit_allocation import MonotoneDense

COLLECTIONS = ("params", "batch_stats", "quant_stats", "buffers")
_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm)


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _target(module: nn.Module, collection: str, leaf: str):
    """(torch tensor, converter numpy->torch layout) for one flax leaf."""
    if collection == "params":
        if isinstance(module, nn.Conv2d):
            if leaf == "kernel":
                return module.weight, lambda a: a.transpose(3, 2, 0, 1)
            if leaf == "bias":
                return module.bias, None
        elif isinstance(module, nn.Linear):
            if leaf == "kernel":
                return module.weight, lambda a: a.T
            if leaf == "bias":
                return module.bias, None
        elif isinstance(module, _NORMS):
            if leaf in ("scale", "bias"):
                return (module.weight if leaf == "scale" else module.bias), None
        elif isinstance(module, MonotoneDense):
            if leaf in ("theta", "bias"):
                return getattr(module, leaf), None
    elif collection == "batch_stats" and isinstance(module, _NORMS):
        if leaf in ("mean", "var"):
            return getattr(module, "running_" + leaf), None
    elif collection in ("quant_stats", "buffers"):
        if leaf in dict(module.named_buffers(recurse=False)):
            return getattr(module, leaf), None
    return None, None


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Copy a flax variable tree into `model` in place (values are cast to
    each tensor's dtype and device).  Raises ValueError on a leaf with no
    counterpart or with another shape."""
    with torch.no_grad():
        for col in COLLECTIONS:
            for path, value in _leaves(variables.get(col, {})):
                name = "/".join((col,) + path)
                try:
                    module = model.get_submodule(".".join(path[:-1]))
                except AttributeError:
                    raise ValueError(f"no module for {name}") from None
                tensor, conv = _target(module, col, path[-1])
                if tensor is None:
                    raise ValueError(f"no tensor for {name}")
                arr = np.asarray(value)
                if conv is not None:
                    arr = conv(arr)
                if tuple(arr.shape) != tuple(tensor.shape):
                    raise ValueError(
                        f"shape mismatch at {name}: {arr.shape} vs {tuple(tensor.shape)}")
                tensor.copy_(torch.from_numpy(np.array(arr)))  # a C-order copy, 0-d kept
    return model


def to_jax_variables(model: nn.Module) -> Dict[str, Dict]:
    """The model's weights and state as a flax variable tree of numpy arrays."""
    out: Dict[str, Dict] = {c: {} for c in COLLECTIONS}

    def put(col, path, tensor, conv=None):
        arr = tensor.detach().to("cpu")
        if arr.is_floating_point():
            arr = arr.to(torch.float32)
        arr = arr.numpy()
        if conv is not None:
            arr = conv(arr)
        node = out[col]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(arr)

    for qual, m in model.named_modules():
        path = tuple(qual.split(".")) if qual else ()
        if isinstance(m, nn.Conv2d):
            put("params", path + ("kernel",), m.weight, lambda a: a.transpose(2, 3, 1, 0))
            if m.bias is not None:
                put("params", path + ("bias",), m.bias)
        elif isinstance(m, nn.Linear):
            put("params", path + ("kernel",), m.weight, lambda a: a.T)
            put("params", path + ("bias",), m.bias)
        elif isinstance(m, _NORMS):
            put("params", path + ("scale",), m.weight)
            put("params", path + ("bias",), m.bias)
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                put("batch_stats", path + ("mean",), m.running_mean)
                put("batch_stats", path + ("var",), m.running_var)
        elif isinstance(m, MonotoneDense):
            put("params", path + ("theta",), m.theta)
            put("params", path + ("bias",), m.bias)
        for bname, buf in m.named_buffers(recurse=False):
            if bname in ("running_min", "running_max", "num_batches", "frozen"):
                put("quant_stats", path + (bname,), buf)
            elif bname == "feature_weights":
                put("buffers", path + (bname,), buf)
    return {c: v for c, v in out.items() if v}
