"""Area attentions evaluated a deployed call: the program's counter
`area_attention` (one for each AAttn of YOLO12's ABlocks, models/layers.py;
16 a forward of yolo12l) counted inside the traced calls' root spans
'deployed_program', over those calls
(mcaq_yolo_tpu_torch/utils/profiling.py).  None where the program records
no spans or no such counter."""

COUNTER = "area_attention"
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
