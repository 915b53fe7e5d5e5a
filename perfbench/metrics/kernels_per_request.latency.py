"""CUDA kernels a request launches: the kernels of the profiled
sub-window over its requests."""


def read(ctx):
    return len(ctx["trace"].kernels) / ctx["requests"] if ctx["trace"].kernels else None
