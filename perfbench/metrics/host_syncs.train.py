"""Host syncs a train step: the program's counter `host_syncs` (one at each
site where the host waits for the card) counted inside the traced steps'
root spans 'train_step', over those steps
(mcaq_yolo_tpu_torch/utils/profiling.py).  None where the program records
no spans."""

COUNTER = "host_syncs"
ROOT = "train_step"


def read(ctx):
    from mcaq_yolo_tpu_torch.utils import profiling

    if not hasattr(profiling, "span_summary"):
        return None
    root = profiling.span_summary()["by_root"].get(ROOT, {"count": 0})
    if root["count"] != ctx["steps"]:
        raise ValueError(f"{root['count']} '{ROOT}' spans recorded over {ctx['steps']} "
                         "traced steps")
    return root["counters"].get(COUNTER, 0) / root["count"]
