"""Share (%) of the card's dense bf16 peak (989 TFLOP/s) in the window: the
network's FLOPs an image (2 x MACs of every convolution, counted from the
shapes; perfbench/yardsticks.py) times the images served a second."""

from perfbench.yardsticks import BF16_TENSOR_FLOPS


def read(ctx):
    return 100.0 * ctx["flops_per_image"] * ctx["images_per_s"] / BF16_TENSOR_FLOPS
