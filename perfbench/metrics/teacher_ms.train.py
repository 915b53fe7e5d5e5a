"""Device ms of the 'teacher' phase of a training step: CUDA events recorded
at the train step's `mark` seam, median over the marked steps."""


def read(ctx):
    return ctx["split_ms"].get("teacher")
