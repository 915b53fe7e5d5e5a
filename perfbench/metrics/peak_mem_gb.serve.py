"""Peak device memory allocated over the window, GB (10^9 bytes)."""


def read(ctx):
    return ctx["peak_window_bytes"] / 1e9 if ctx.get("peak_window_bytes") else None
