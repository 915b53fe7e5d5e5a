"""Device ms an image of the kernels of each call outside the model's
forward: decode and NMS (models/yolo.py:decode_and_nms, ops/nms.py)."""


def read(ctx):
    s = ctx["trace"].device_seconds(lambda k: "call" in k.ranges and "model" not in k.ranges)
    return None if s is None else s * 1e3 / ctx["images"]
