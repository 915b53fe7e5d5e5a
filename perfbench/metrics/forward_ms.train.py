"""Device ms of the 'forward' phase of a training step: CUDA events recorded
at the train step's `mark` seam, median over the marked steps."""


def read(ctx):
    return ctx["split_ms"].get("forward")
