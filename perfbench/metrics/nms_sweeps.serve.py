"""NMS keep sweeps a deployed call: the program's counter `nms_sweeps`
(ops/nms.py:keep_fixed_point) counted inside the traced calls' root spans
'deployed_program', over those calls
(mcaq_yolo_tpu_torch/utils/profiling.py).  None where the program records
no spans."""

COUNTER = "nms_sweeps"
ROOT = "deployed_program"


def read(ctx):
    from mcaq_yolo_tpu_torch.utils import profiling

    if not hasattr(profiling, "span_summary"):
        return None
    root = profiling.span_summary()["by_root"].get(ROOT, {"count": 0})
    if root["count"] != ctx["calls"]:
        raise ValueError(f"{root['count']} '{ROOT}' spans recorded over {ctx['calls']} "
                         "traced calls")
    return root["counters"].get(COUNTER, 0) / root["count"]
