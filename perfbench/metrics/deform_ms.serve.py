"""Device ms an image of the kernels launched inside the deformable
attention's sampling (models/rtdetr.py DeformSample, six a call), the
`deform` ranges of drivers/serve_batch_rtdetr.py."""


def read(ctx):
    s = ctx["trace"].device_seconds(ctx["trace"].in_range("deform"))
    return None if s is None else s * 1e3 / ctx["images"]
