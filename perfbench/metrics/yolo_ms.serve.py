"""Device ms an image of the kernels launched inside the program's
backbone, neck and Detect head (models/yolo.py)."""


def read(ctx):
    s = ctx["trace"].device_seconds(ctx["trace"].in_range("backbone", "neck", "head"))
    return None if s is None else s * 1e3 / ctx["images"]
