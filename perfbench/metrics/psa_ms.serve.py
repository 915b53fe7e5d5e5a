"""Device ms an image of the kernels launched inside the backbone's C2PSA
(YOLO11's attention block: models/layers.py C2PSA, PSABlock, Attention)."""


def read(ctx):
    s = ctx["trace"].device_seconds(ctx["trace"].in_range("psa"))
    return None if s is None else s * 1e3 / ctx["images"]
