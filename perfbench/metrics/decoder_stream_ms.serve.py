"""Stream ms an image of RT-DETR's decoder: the program's span
'rtdetr.decoder' (mcaq_yolo_tpu_torch/models/rtdetr.py: the whole
RTDETRDecoder, input projections, anchors, encoder output, selection and
the six layers, the work of decoder_ms.serve's `decoder` range), timed by
CUDA events at the span's ends in mcaq_yolo_tpu_torch/utils/profiling.py,
so the card's idle time inside it counts, over the traced calls' images.
None where the program records no such span."""

NAME = "rtdetr.decoder"
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
