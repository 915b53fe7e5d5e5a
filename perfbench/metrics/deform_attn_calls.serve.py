"""Deformable samplings a deployed call: the program's counter
`deform_attn` (one for each sampling of models/rtdetr.py DeformSample, six
a forward) counted inside the traced calls' root spans 'deployed_program',
over those calls (mcaq_yolo_tpu_torch/utils/profiling.py).  None where the
program records no spans or no such counter."""

COUNTER = "deform_attn"
ROOT = "deployed_program"


def read(ctx):
    from mcaq_yolo_tpu_torch.utils import profiling

    if not hasattr(profiling, "span_summary"):
        return None
    root = profiling.span_summary()["by_root"].get(ROOT, {"count": 0})
    if root["count"] != ctx["calls"]:
        raise ValueError(f"{root['count']} '{ROOT}' spans recorded over {ctx['calls']} "
                         "traced calls")
    n = root["counters"].get(COUNTER)
    return None if n is None else n / root["count"]
