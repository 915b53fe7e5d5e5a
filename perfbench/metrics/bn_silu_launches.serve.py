"""Eval BatchNorm + SiLU kernel launches a deployed call: the program's
counter `bn_silu` (one at each launch of csrc/bn_silu.cu, one a ConvBnSiLU
of the network in eval on the card) counted inside the traced calls' root
spans 'deployed_program', over those calls
(mcaq_yolo_tpu_torch/utils/profiling.py).  None where the program has no
such kernel (mcaq_yolo_tpu_torch/ops/bn_silu.py) or records no spans."""

import importlib.util

COUNTER = "bn_silu"
ROOT = "deployed_program"


def read(ctx):
    from mcaq_yolo_tpu_torch.utils import profiling

    if (importlib.util.find_spec("mcaq_yolo_tpu_torch.ops.bn_silu") is None
            or not hasattr(profiling, "span_summary")):
        return None
    root = profiling.span_summary()["by_root"].get(ROOT, {"count": 0})
    if root["count"] != ctx["calls"]:
        raise ValueError(f"{root['count']} '{ROOT}' spans recorded over {ctx['calls']} "
                         "traced calls")
    return root["counters"].get(COUNTER, 0) / root["count"]
