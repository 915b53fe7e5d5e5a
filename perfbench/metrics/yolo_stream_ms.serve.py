"""Stream ms an image of the backbone, neck and Detect head: the program's
spans 'model.backbone', 'model.neck' and 'model.head'
(mcaq_yolo_tpu_torch/utils/profiling.py: CUDA events at each span's ends,
so the card's idle time inside them counts) over the traced calls' images.
None where the program records no spans."""

NAMES = ("model.backbone", "model.neck", "model.head")
ROOT = "deployed_program"


def read(ctx):
    from mcaq_yolo_tpu_torch.utils import profiling

    if not hasattr(profiling, "span_summary"):
        return None
    s = profiling.span_summary()
    roots = s["by_root"].get(ROOT, {}).get("count", 0)
    if roots != ctx["calls"]:
        raise ValueError(f"{roots} '{ROOT}' spans recorded over {ctx['calls']} traced calls")
    ms = [s["spans"][n]["stream_ms"] for n in NAMES if n in s["spans"]]
    return None if not ms or None in ms else sum(ms) / ctx["images"]
