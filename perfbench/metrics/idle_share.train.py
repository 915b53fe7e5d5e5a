"""Share (%) of the profiled sub-window in which no operation ran on the
card (the union of kernel, copy and set intervals against the wall time)."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.window_s > 0 else None
