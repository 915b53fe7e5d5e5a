"""Training quantize kernel launches a train step: the program's counter
`frac_quant` (one at each launch of csrc/frac_quant.cu's C entries: the
forward and the backward of each of the student's three quantizers)
counted inside the traced steps' root spans 'train_step', over those steps
(mcaq_yolo_tpu_torch/utils/profiling.py).  None where the program has no
such kernel (mcaq_yolo_tpu_torch/ops/frac_quant.py) or records no spans."""

import importlib.util

COUNTER = "frac_quant"
ROOT = "train_step"


def read(ctx):
    from mcaq_yolo_tpu_torch.utils import profiling

    if (importlib.util.find_spec("mcaq_yolo_tpu_torch.ops.frac_quant") is None
            or not hasattr(profiling, "span_summary")):
        return None
    root = profiling.span_summary()["by_root"].get(ROOT, {"count": 0})
    if root["count"] != ctx["steps"]:
        raise ValueError(f"{root['count']} '{ROOT}' spans recorded over {ctx['steps']} "
                         "traced steps")
    return root["counters"].get(COUNTER, 0) / root["count"]
