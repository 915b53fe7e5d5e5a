"""Share (%) of the card's dense bf16 peak (989 TFLOP/s) in the window: the
step's FLOPs an image (the student's forward and its backward, counted as
twice the forward, and the teacher's forward: 2 x MACs of every convolution
from the shapes; perfbench/yardsticks.py) times the images trained a second."""

from perfbench.yardsticks import BF16_TENSOR_FLOPS


def read(ctx):
    return 100.0 * ctx["flops_per_image"] * ctx["images_per_s"] / BF16_TENSOR_FLOPS
