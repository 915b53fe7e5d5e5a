"""Device ms an image of the MCAQ transform: the kernels launched inside
the complexity analyzer, the bit mapper and the three quantizers
(core/morphology, core/bit_allocation, core/quantization)."""

LAYERS = ("complexity_analyzer", "bit_mapper", "quantizer_p3", "quantizer_p4", "quantizer_p5")


def read(ctx):
    s = ctx["trace"].device_seconds(ctx["trace"].in_range(*LAYERS))
    return None if s is None else s * 1e3 / ctx["images"]
