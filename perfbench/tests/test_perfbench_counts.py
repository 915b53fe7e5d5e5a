"""The yardsticks against hand-worked small cases."""

import torch

from perfbench import yardsticks as y
from perfbench.reference import network as rn


def test_quant_bytes_and_ops():
    # x (1, 2, 2, 8) bf16 read and written: 2 * 32 * 2 = 128; bit map 1 x 1
    # float: 4; range 2 * 8 floats: 64; mask 4 floats: 16
    assert y.quant_bytes(1, 2, 2, 8, 2, 1, 1) == 128 + 4 + 64 + 16
    assert y.quant_bytes(1, 2, 2, 8, 2, 1, 1, mask=False) == 128 + 4 + 64
    assert y.quant_ops(1, 2, 2, 8) == 32 * 8


def test_phi_counts():
    assert sum(y.PHI_OPS_PER_PIXEL.values()) == 26 + 148 + 45 + 42 + 12 + 16 + 2 + 1
    assert y.phi_tiles_ops(100) == 292 * 100
    # gray (2, 8, 8) float read: 512 bytes; 2 x 2 x 2 tiles x 8 floats written: 256
    assert y.phi_tiles_bytes(2, 8, 8, 4) == 512 + 256


def test_bound_takes_the_longer():
    assert y.bound_s(3.35e12, 0) == 1.0
    assert y.bound_s(0, 67e12) == 1.0
    assert y.bound_s(3.35e12, 2 * 67e12) == 2.0


def test_conv_flops_of_one_conv():
    conv = torch.nn.Conv2d(3, 4, 3, 2, 1, bias=False)
    # output 4 x 2 x 2, each 3 * 3 * 3 = 27 MACs: 2 * 16 * 27
    assert rn.conv_flops(conv, torch.zeros(1, 3, 4, 4)) == 2 * 16 * 27


def test_network_flops_match_the_published_gflops():
    # Ultralytics' yolov8.yaml: 8.7 GFLOPs (n) and 78.9 (m) at 640
    assert abs(y.network_flops("yolov8n", 80, 640) / 1e9 - 8.7) < 0.05
    assert abs(y.network_flops("yolov8m", 80, 640) / 1e9 - 78.9) < 0.05
    assert y.train_flops_per_image("yolov8n", 80, 640) == 4 * y.network_flops("yolov8n", 80, 640)


def test_scale_shapes_at_640():
    s = y.scale_shapes(640, "yolov8n", 8, 2)
    assert [(d["H"], d["C"], d["Ht"], d["Hg"], d["tile"]) for d in s] == [
        (80, 64, 10, 40, 4), (40, 128, 10, 40, 4), (20, 256, 5, 20, 4)]
    assert [d["C"] for d in y.scale_shapes(640, "yolov8m", 8, 1)] == [192, 384, 576]
