"""Host ms of a request outside the Predictor's call into the deployed
program (letterbox, H2D, the wait for and copy of the results, the
unletterbox): the request's wall time less the span around that call,
median over the timed requests."""


def read(ctx):
    return ctx.get("host_ms")
