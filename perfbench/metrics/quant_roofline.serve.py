"""Share (%) of its roofline that the spatial quantize kernel
(csrc/spatial_quant.cu) reaches: the least time of the traced calls' three
quantizes (perfbench/yardsticks.py: bytes at the HBM rate or float32
operations at the CUDA-core rate, the longer) over the device time of its
two kernels, the table kernel and the quantize kernel."""


def read(ctx):
    t = ctx["trace"].device_seconds(ctx["trace"].named("qparams_kernel", "spatial_quant_kernel"))
    return None if not t else 100.0 * ctx["quant_bound_s"] / t
