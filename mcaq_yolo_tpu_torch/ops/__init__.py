"""The CUDA spatial-quantize kernel and NMS (exports resolved at first use;
importing `ops.spatial_quant` registers the op, building nothing)."""

from .._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "batched_nms": ".nms",
    "non_max_suppression": ".nms",
})
