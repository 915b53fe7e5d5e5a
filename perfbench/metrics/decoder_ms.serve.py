"""Device ms an image of the kernels launched inside RT-DETR's decoder
(models/rtdetr.py RTDETRDecoder: input projections, encoder output, query
selection, the six decoder layers), the `decoder` range of
drivers/serve_batch_rtdetr.py."""


def read(ctx):
    s = ctx["trace"].device_seconds(ctx["trace"].in_range("decoder"))
    return None if s is None else s * 1e3 / ctx["images"]
