"""Stream ms an image of YOLO12's A2C2f blocks with area attention: the
program's spans 'model.a2c2f' (mcaq_yolo_tpu_torch/models/layers.py, timed
by CUDA events at the spans' ends in mcaq_yolo_tpu_torch/utils/profiling.py,
so the card's idle time inside them counts) over the traced calls' images.
None where the program records no such span."""

NAME = "model.a2c2f"
ROOT = "deployed_program"


def read(ctx):
    from mcaq_yolo_tpu_torch.utils import profiling

    if not hasattr(profiling, "span_summary"):
        return None
    s = profiling.span_summary()
    roots = s["by_root"].get(ROOT, {}).get("count", 0)
    if roots != ctx["calls"]:
        raise ValueError(f"{roots} '{ROOT}' spans recorded over {ctx['calls']} traced calls")
    ms = s["spans"].get(NAME, {}).get("stream_ms")
    return None if ms is None else ms / ctx["images"]
