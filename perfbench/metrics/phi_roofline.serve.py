"""Share (%) of its roofline that the phi kernel (csrc/morph_tiles.cu)
reaches: the least time of the traced calls' three phi_tiles launches
(perfbench/yardsticks.py: the gray map read and phi written at the HBM rate,
or its float32 operations at the CUDA-core rate, the longer) over the device
time of its warp and block kernels."""


def read(ctx):
    t = ctx["trace"].device_seconds(ctx["trace"].named("phi_warp_kernel", "phi_block_kernel"))
    return None if not t else 100.0 * ctx["phi_bound_s"] / t
