"""Device ms an image of the kernels launched inside the backbone's two
A2C2f blocks with area attention (YOLO12's P4 and P5 stages:
models/layers.py A2C2f, ABlock, AAttn), the `area` ranges of
drivers/serve_batch_y12.py."""


def read(ctx):
    s = ctx["trace"].device_seconds(ctx["trace"].in_range("area"))
    return None if s is None else s * 1e3 / ctx["images"]
