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
  MonotoneDense theta stays (in, out); A2C2f's layer scale gamma stays (C,)
  quant_stats / buffers -> the module buffer of the same name

`to_jax_variables(model)` is the inverse (float32 arrays, int32
num_batches, bool frozen).

`params_tree(model, value_of)` and `params_from_tree(model, tree)` carry
any per-parameter tensors (AdamW's moments) through the same layout
transforms, for the optimizer state in optax's layout (`train.py`).

`convert_torch_yolov8(state_dict, strict)` maps an Ultralytics YOLOv8
DetectionModel state_dict (`model.{i}.*` keys) onto the flax tree, and
`load_pretrained_into(model, state_dict, strict)` loads it into the port's
backbone, neck and head through `load_jax_variables` (a port of
`mcaq_yolo_tpu/models/weights_io.py:27-240`): conv OIHW -> HWIO, BN
weight / bias -> scale / bias, running statistics -> batch_stats.  A full
Ultralytics `.pt` pickle embeds that package's classes and cannot be read
without it; accepted are a plain state_dict file
(`torch.save(YOLO('yolov8n.pt').model.state_dict(), 'yolov8n_sd.pt')`) or
a dict of tensors or arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.bit_allocation import MonotoneDense
from ..core.quantization import LearnedRoundingQuantization
from ..utils.checkpoint import copy_full_, full_tensor
from .layers import A2C2f

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
        elif isinstance(module, LearnedRoundingQuantization) and leaf == "alpha":
            return module.alpha, None
        elif isinstance(module, A2C2f) and leaf == "gamma" and module.gamma is not None:
            return module.gamma, None
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
                copy_full_(tensor, torch.from_numpy(np.array(arr)))  # a C-order copy, 0-d kept
    return model


# the torch dims of a Conv kernel (OIHW) and a Dense kernel ((out, in)) in
# the order of their flax layouts (HWIO, (in, out))
_CONV_AXES = (2, 3, 1, 0)
_DENSE_AXES = (1, 0)


def param_leaves(model: nn.Module):
    """(flax params path, parameter, axes) for every parameter of `model`:
    `axes` are the parameter's dims in the order of its flax layout (None:
    the same layout), so `np.transpose(a, axes)` takes a torch array to
    flax and flax dim i is torch dim axes[i]."""
    for qual, m in model.named_modules():
        path = tuple(qual.split(".")) if qual else ()
        if isinstance(m, nn.Conv2d):
            yield path + ("kernel",), m.weight, _CONV_AXES
            if m.bias is not None:
                yield path + ("bias",), m.bias, None
        elif isinstance(m, nn.Linear):
            yield path + ("kernel",), m.weight, _DENSE_AXES
            yield path + ("bias",), m.bias, None
        elif isinstance(m, _NORMS):
            yield path + ("scale",), m.weight, None
            yield path + ("bias",), m.bias, None
        elif isinstance(m, MonotoneDense):
            yield path + ("theta",), m.theta, None
            yield path + ("bias",), m.bias, None
        elif isinstance(m, LearnedRoundingQuantization):
            yield path + ("alpha",), m.alpha, None
        elif isinstance(m, A2C2f) and m.gamma is not None:
            yield path + ("gamma",), m.gamma, None


def _put(tree: Dict, path, tensor: torch.Tensor, axes=None) -> None:
    arr = full_tensor(tensor).detach().to("cpu")
    if arr.is_floating_point():
        arr = arr.to(torch.float32)
    arr = arr.numpy()
    if axes is not None:
        arr = np.transpose(arr, axes)
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.array(arr)


def params_tree(model: nn.Module,
                value_of: Callable[[nn.Parameter], torch.Tensor]) -> Dict:
    """A flax 'params'-layout tree holding value_of(p) (a tensor of p's
    shape; a sharded DTensor is gathered whole) for every parameter p, with
    the parameters' layout transforms."""
    tree: Dict = {}
    for path, p, axes in param_leaves(model):
        _put(tree, path, value_of(p), axes)
    return tree


def params_from_tree(model: nn.Module, tree: Dict) -> Dict[nn.Parameter, torch.Tensor]:
    """The inverse of `params_tree`: parameter -> float32 CPU tensor in the
    parameter's layout (whole, also for a sharded parameter).  Raises
    ValueError on a missing, extra or misshapen leaf."""
    leaves = dict(_leaves(tree))
    out = {}
    for path, p, axes in param_leaves(model):
        if path not in leaves:
            raise ValueError(f"no leaf for {'/'.join(path)}")
        arr = np.asarray(leaves.pop(path), np.float32)
        if axes is not None:
            arr = np.transpose(arr, np.argsort(axes))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch at {'/'.join(path)}: {arr.shape} vs "
                             f"{tuple(p.shape)}")
        out[p] = torch.from_numpy(np.array(arr))
    if leaves:
        raise ValueError(f"leaves with no parameter: {sorted(leaves)[:3]}")
    return out


def to_jax_variables(model: nn.Module) -> Dict[str, Dict]:
    """The model's weights and state as a flax variable tree of numpy arrays."""
    out: Dict[str, Dict] = {c: {} for c in COLLECTIONS}
    out["params"] = params_tree(model, lambda p: p)
    for qual, m in model.named_modules():
        path = tuple(qual.split(".")) if qual else ()
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            _put(out["batch_stats"], path + ("mean",), m.running_mean)
            _put(out["batch_stats"], path + ("var",), m.running_var)
        for bname, buf in m.named_buffers(recurse=False):
            if bname in ("running_min", "running_max", "num_batches", "frozen", "histogram"):
                _put(out["quant_stats"], path + (bname,), buf)
            elif bname == "feature_weights":
                _put(out["buffers"], path + (bname,), buf)
    return {c: v for c, v in out.items() if v}


# ---------------------------------------------------------------------------
# Ultralytics YOLOv8 state_dicts
# ---------------------------------------------------------------------------

# Ultralytics layer index -> flax module name, for the standard YOLOv8
# topology (backbone 0-9, neck 10-21, Detect head 22)
_BACKBONE_MAP = {0: "ConvBnSiLU_0", 1: "ConvBnSiLU_1", 2: "C2f_0", 3: "ConvBnSiLU_2",
                 4: "C2f_1", 5: "ConvBnSiLU_3", 6: "C2f_2", 7: "ConvBnSiLU_4", 8: "C2f_3",
                 9: "SPPF_0"}
_NECK_MAP = {12: "C2f_0", 15: "C2f_1", 16: "ConvBnSiLU_0", 18: "C2f_2", 19: "ConvBnSiLU_1",
             21: "C2f_3"}
HEAD_IDX = 22


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv_kernel(t) -> np.ndarray:
    """torch OIHW -> flax HWIO."""
    return _to_np(t).transpose(2, 3, 1, 0)


def _set(tree: Dict, path, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _convert_convbn(sd, prefix: str, params: Dict, stats: Dict, path) -> None:
    """Ultralytics Conv block: {prefix}.conv.weight + {prefix}.bn.*"""
    _set(params, path + ("Conv_0", "kernel"), _conv_kernel(sd[f"{prefix}.conv.weight"]))
    _set(params, path + ("BatchNorm_0", "scale"), _to_np(sd[f"{prefix}.bn.weight"]))
    _set(params, path + ("BatchNorm_0", "bias"), _to_np(sd[f"{prefix}.bn.bias"]))
    _set(stats, path + ("BatchNorm_0", "mean"), _to_np(sd[f"{prefix}.bn.running_mean"]))
    _set(stats, path + ("BatchNorm_0", "var"), _to_np(sd[f"{prefix}.bn.running_var"]))


def _convert_c2f(sd, prefix, params, stats, path) -> None:
    _convert_convbn(sd, f"{prefix}.cv1", params, stats, path + ("ConvBnSiLU_0",))
    n = 0
    while f"{prefix}.m.{n}.cv1.conv.weight" in sd:
        for j in (1, 2):  # Bottleneck: cv1, cv2
            _convert_convbn(sd, f"{prefix}.m.{n}.cv{j}", params, stats,
                            path + (f"Bottleneck_{n}", f"ConvBnSiLU_{j - 1}"))
        n += 1
    _convert_convbn(sd, f"{prefix}.cv2", params, stats, path + ("ConvBnSiLU_1",))


def _convert_sppf(sd, prefix, params, stats, path) -> None:
    _convert_convbn(sd, f"{prefix}.cv1", params, stats, path + ("ConvBnSiLU_0",))
    _convert_convbn(sd, f"{prefix}.cv2", params, stats, path + ("ConvBnSiLU_1",))


def _convert_detect(sd, prefix, params, stats) -> None:
    """The legacy (YOLOv8) Detect head: per scale i, cv2[i] is the box
    branch and cv3[i] the class branch, each Conv, Conv, Conv2d."""
    for i in range(3):
        for branch, name in (("cv2", "box"), ("cv3", "cls")):
            for j in (0, 1):
                _convert_convbn(sd, f"{prefix}.{branch}.{i}.{j}", params, stats,
                                ("head", f"{name}{i}_conv{j}"))
            _set(params, ("head", f"{name}{i}_out", "kernel"),
                 _conv_kernel(sd[f"{prefix}.{branch}.{i}.2.weight"]))
            _set(params, ("head", f"{name}{i}_out", "bias"),
                 _to_np(sd[f"{prefix}.{branch}.{i}.2.bias"]))
    # dfl.conv is the fixed arange(REG_MAX) expectation kernel: `dfl_decode`
    # has no parameter for it


class _TrackedSD(dict):
    """A state_dict that records every key the converter reads, so that the
    source checkpoint's coverage can be checked."""

    def __init__(self, data):
        super().__init__(data)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)


def _ignorable_source_key(key: str) -> bool:
    """Keys of real Ultralytics state_dicts that are right to skip: the
    BatchNorm counters and the Detect head's fixed DFL expectation kernel."""
    return key.endswith("num_batches_tracked") or key == f"{HEAD_IDX}.dfl.conv.weight"


def convert_torch_yolov8(state_dict, strict: bool = True) -> Tuple[Dict, Dict]:
    """Ultralytics DetectionModel state_dict (or the path of a plain
    state_dict file) -> (params, batch_stats) flax trees of numpy arrays
    for the backbone, neck and head.

    strict=True: raise if any source key (beyond the BatchNorm counters and
    the DFL kernel) was not consumed, since a silently dropped key means the
    checkpoint's topology and this map disagree."""
    if isinstance(state_dict, (str, bytes, Path)):
        # weights_only: a plain state_dict loads, and an untrusted pickle
        # cannot run code
        obj = torch.load(state_dict, map_location="cpu", weights_only=True)
        if not (isinstance(obj, dict) and all(hasattr(v, "shape") for v in obj.values())):
            raise ValueError("Unsupported checkpoint format: export a plain state_dict "
                             "(see the module docstring)")
        state_dict = obj
    sd = _TrackedSD({k.removeprefix("model.model.").removeprefix("model."): v
                     for k, v in state_dict.items()})
    params: Dict = {"backbone": {}, "neck": {}, "head": {}}
    stats: Dict = {"backbone": {}, "neck": {}, "head": {}}
    for idx, name in _BACKBONE_MAP.items():
        if name.startswith("ConvBnSiLU"):
            _convert_convbn(sd, str(idx), params, stats, ("backbone", name))
        elif name.startswith("C2f"):
            _convert_c2f(sd, str(idx), params, stats, ("backbone", name))
        else:
            _convert_sppf(sd, str(idx), params, stats, ("backbone", name))
    for idx, name in _NECK_MAP.items():
        if name.startswith("ConvBnSiLU"):
            _convert_convbn(sd, str(idx), params, stats, ("neck", name))
        else:
            _convert_c2f(sd, str(idx), params, stats, ("neck", name))
    _convert_detect(sd, str(HEAD_IDX), params, stats)

    unconsumed = sorted(k for k in sd if k not in sd.consumed and not _ignorable_source_key(k))
    if unconsumed and strict:
        raise ValueError(
            f"{len(unconsumed)} source checkpoint key(s) were NOT consumed by the conversion "
            f"(topology mismatch?): {unconsumed[:10]}" + (" ..." if len(unconsumed) > 10 else ""))
    return params, stats


def load_pretrained_into(model: nn.Module, state_dict, strict: bool = True) -> nn.Module:
    """Load converted Ultralytics weights into the backbone, neck and head of
    `model` (the port's YOLOv8 or MCAQYOLO), in place; the rest of the model
    keeps its values.  Every converted leaf must exist in the model's flax
    tree with the same shape (KeyError / ValueError otherwise); with
    strict=True every source key must be consumed too."""
    params, stats = convert_torch_yolov8(state_dict, strict=strict)
    template = to_jax_variables(model)

    def check(dst: Dict, src: Dict, path: str) -> None:
        for k, v in src.items():
            if k not in dst:
                raise KeyError(f"converted key {path}/{k} missing in target tree")
            if isinstance(v, dict):
                check(dst[k], v, f"{path}/{k}")
            elif tuple(dst[k].shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {path}/{k}: {dst[k].shape} vs {v.shape}")

    check(template["params"], params, "")
    check(template["batch_stats"], stats, "")
    return load_jax_variables(model, {"params": params, "batch_stats": stats})
