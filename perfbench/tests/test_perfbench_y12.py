"""Cell `l12-serve-bs256` (YOLO12-L): its driver's yardsticks at the cell's
size, and the cell run on the CPU at 64 px from its own files
(`configs/yolo12l-mcaq.json`, `traffic/serve_batch_device_y12.json`,
`drivers/serve_batch_y12.py`, `reference/yolo12.py`, `limits/` and the four
`area_*` readers); the control (the reference one precision below: float8
convolutions and attention operands, TF32 MCAQ math, bf16 decode and NMS)
fails the cell's limits, on the CPU at 64 px and on the card (`gpu`) at the
cell's size."""

import pytest
import torch

from perfbench import run
from perfbench import yardsticks as y
from perfbench.drivers import serve_batch_y11
from perfbench.drivers import serve_batch_y12 as d
from perfbench.reference import yolo12 as ry
from perfbench.tests.helpers import run_tiny, tiny_cell


def test_flops_are_the_convolutions_and_the_area_attention_products():
    convs, products = ry.network_flops("yolo12l", 80, 640)
    # Ultralytics' yolo12.yaml: 88.9 GFLOPs of convolutions at 640
    assert abs(convs / 1e9 - 88.88) < 0.005
    # 8 attentions at P4 (8 heads of 32, 4 areas of 400 tokens) and 8 at P5
    # (one area of 400): q^T k and v attn^T, 32 deep each
    assert products == 8 * (2 * 8 * 4 * 400 * 400 * 64) + 8 * (2 * 8 * 400 * 400 * 64)
    assert d.flops_per_image("yolo12l", 80, 640) == convs + products


def test_the_attention_cores_bound_is_their_bytes():
    # a bs-256 call: q, k, v and o in bf16 (16 attentions of 256 channels
    # over 1600 or 400 tokens), 8.39 GB; the products 1.68 TFLOP
    n_bytes = 256 * (8 * 4 * 1600 * 256 * 2 + 8 * 4 * 400 * 256 * 2)
    assert d.area_attn_bytes(256, 640, "yolo12l") == n_bytes == 8_388_608_000
    assert d.area_attn_flops(256, 640, "yolo12l") == 256 * 6_553_600_000
    bound = d.area_attn_bound_s(256, 640, "yolo12l")
    assert bound == pytest.approx(n_bytes / y.HBM_BYTES_PER_S, rel=1e-12)
    assert bound > d.area_attn_flops(256, 640, "yolo12l") / y.BF16_TENSOR_FLOPS
    assert 2.4e-3 < bound < 2.6e-3


def test_serve_bounds_at_the_512_channel_taps():
    c = run.cell("l12-serve-bs256")["config"]
    assert c["c3_c4_c5_channels"] == list(ry.variant_channels("yolo12l")) == [512, 512, 512]
    assert serve_batch_y11.serve_bounds(256, 640, c["c3_c4_c5_channels"], 8, 2) == \
        serve_batch_y11.serve_bounds(256, 640, (512, 512, 512), 8, 2)


def test_l12_cell_runs_correct_on_the_cpu():
    res = run_tiny("l12-serve-bs256", trace=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res["checks"]
    assert "attn_rel_err_given" in res["checks"]
    assert res["metrics"]["area_attention_calls.serve"]["value"] == 16.0
    assert res["metrics"]["bn_silu_launches.serve"]["value"] == 0.0  # no kernel on the CPU
    # no device kernels and no CUDA events on the CPU
    for name in ("area_ms.serve", "area_stream_ms.serve", "area_attn_roofline.serve"):
        assert name not in res["metrics"]


def _control(c, device, seed=246813579):
    drv = d.Driver(c["config"], c["traffic"], seed, device, lambda o: None)
    drv.setup()
    drv.window(0.5)
    drv.release()
    return drv.check(), drv.control()


def _failed(c, numbers):
    return [k for k, lim in c["limits"].items() if not k.startswith("_") and numbers[k] > lim]


def test_control_fails_at_a_small_size():
    torch.set_num_threads(2)
    c = tiny_cell("l12-serve-bs256")
    prog, ctrl = _control(c, torch.device("cpu"))
    assert not _failed(c, prog), prog
    assert _failed(c, ctrl), ctrl
    assert ctrl["attn_rel_err_given"] > c["limits"]["attn_rel_err_given"], ctrl


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.cache_env()
    c = run.cell("l12-serve-bs256")
    prog, ctrl = _control(c, torch.device("cuda", 0))
    assert not _failed(c, prog), prog
    assert _failed(c, ctrl), ctrl
    assert ctrl["attn_rel_err_given"] > c["limits"]["attn_rel_err_given"], ctrl
