"""Share (%) of its roofline that YOLO12's attention core reaches: the
least time of the traced calls' cores (`area_attn_bound_s`: q, k, v and o
in bf16 at the HBM rate, or the two products at the bf16 tensor-core rate,
the longer; drivers/serve_batch_y12.py) over the device time of the kernels
in the `area_sdpa` ranges (the parameter-free `sdpa` submodule of every
AAttn, models/layers.py AreaSDPA).  None where the cell has no such bound
or no such kernel ran."""


def read(ctx):
    t = ctx["trace"].device_seconds(ctx["trace"].in_range("area_sdpa"))
    if not t or "area_attn_bound_s" not in ctx:
        return None
    return 100.0 * ctx["area_attn_bound_s"] / t
