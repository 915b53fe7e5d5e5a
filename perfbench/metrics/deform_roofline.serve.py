"""Share (%) of its roofline that the deformable sampling reaches: the
least time of the traced calls' samplings (`deform_bound_s`, the bytes of
drivers/serve_batch_rtdetr.py:deform_bytes at the HBM rate, or its float32
operations at the CUDA-core rate, the longer) over the device time of the
kernels in the `deform` ranges.  None where the cell has no such bound or
no such kernel ran."""


def read(ctx):
    t = ctx["trace"].device_seconds(ctx["trace"].in_range("deform"))
    return None if not t or "deform_bound_s" not in ctx else 100.0 * ctx["deform_bound_s"] / t
