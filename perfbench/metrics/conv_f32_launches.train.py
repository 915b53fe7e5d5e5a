"""Float32 convolution kernel launches a train step: the program's counter
`conv_f32` (one at each launch of csrc/conv_f32.py: each ConvBnSiLU of the
float32 KD teacher, which runs without gradient and outside autocast; the
student's bf16 forward takes none) counted inside the traced steps' root
spans 'train_step', over those steps (mcaq_yolo_tpu_torch/utils/profiling.py).
None where the program has no such kernel (mcaq_yolo_tpu_torch/ops/conv_f32.py)
or records no spans."""

import importlib.util

COUNTER = "conv_f32"
ROOT = "train_step"


def read(ctx):
    from mcaq_yolo_tpu_torch.utils import profiling

    if (importlib.util.find_spec("mcaq_yolo_tpu_torch.ops.conv_f32") is None
            or not hasattr(profiling, "span_summary")):
        return None
    root = profiling.span_summary()["by_root"].get(ROOT, {"count": 0})
    if root["count"] != ctx["steps"]:
        raise ValueError(f"{root['count']} '{ROOT}' spans recorded over {ctx['steps']} "
                         "traced steps")
    return root["counters"].get(COUNTER, 0) / root["count"]
