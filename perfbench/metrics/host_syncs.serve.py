"""Host syncs a deployed call: the program's counter `host_syncs` (one at
each site where the host waits for the card) counted inside the traced
calls' root spans 'deployed_program', over those calls
(mcaq_yolo_tpu_torch/utils/profiling.py).  None where the program records
no spans."""

COUNTER = "host_syncs"
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
