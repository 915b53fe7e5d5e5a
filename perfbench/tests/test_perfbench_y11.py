"""Cell `l11-serve-bs256` (YOLO11l): its driver's yardsticks at the cell's
size, and the cell run on the CPU at 64 px from its own files
(`configs/yolo11l-mcaq.json`, `traffic/serve_batch_device_y11.json`,
`drivers/serve_batch_y11.py`, `reference/yolo11.py`, `limits/` and the
three `psa_*` readers); the control (the reference one precision below:
float8 convolutions and attention products, TF32 MCAQ math, bf16 decode and
NMS) fails the cell's limits, on the CPU at 64 px and on the card (`gpu`)
at the cell's size."""

import pytest
import torch

from perfbench import run
from perfbench import yardsticks as y
from perfbench.drivers import serve_batch_y11 as d
from perfbench.reference import yolo11 as ry
from perfbench.tests.helpers import run_tiny, tiny_cell


def test_flops_are_the_convolutions_and_the_attention_products():
    convs, products = ry.network_flops("yolo11l", 80, 640)
    # Ultralytics' yolo11.yaml: 86.9 GFLOPs of convolutions at 640
    assert abs(convs / 1e9 - 86.9) < 0.05
    # 2 PSABlocks, 4 heads, 400 tokens: q^T k (key_dim 32) and v attn^T (head_dim 64)
    assert products == 2 * (2 * 4 * 400 * 400 * (32 + 64))
    assert d.flops_per_image("yolo11l", 80, 640) == convs + products


def test_serve_bounds_at_the_512_channel_taps():
    q, p = d.serve_bounds(256, 640, (512, 512, 512), 8, 2)
    want_q = sum(y.bound_s(y.quant_bytes(256, h, h, 512, 2, t, t), y.quant_ops(256, h, h, 512))
                 for h, t in ((80, 10), (40, 10), (20, 5)))
    assert q == pytest.approx(want_q, rel=1e-12)
    # the phi kernel reads the gray maps, which do not depend on the channels
    assert p == pytest.approx(y.serve_bounds(256, 640, "yolov8n", 8, 2)[1], rel=1e-12)
    # the same rule as yardsticks.serve_bounds on YOLOv8's taps
    assert d.serve_bounds(256, 640, (192, 384, 576), 8, 2) == pytest.approx(
        y.serve_bounds(256, 640, "yolov8m", 8, 2), rel=1e-12)


def test_l11_cell_runs_correct_on_the_cpu():
    res = run_tiny("l11-serve-bs256", trace=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res["checks"]
    assert res["metrics"]["psa_attention_calls.serve"]["value"] == 2.0
    assert res["metrics"]["bn_silu_launches.serve"]["value"] == 0.0  # no kernel on the CPU
    assert "psa_ms.serve" not in res["metrics"]  # no device kernels on the CPU


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
    c = tiny_cell("l11-serve-bs256")
    prog, ctrl = _control(c, torch.device("cpu"))
    assert not _failed(c, prog), prog
    assert _failed(c, ctrl), ctrl


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.cache_env()
    c = run.cell("l11-serve-bs256")
    prog, ctrl = _control(c, torch.device("cuda", 0))
    assert not _failed(c, prog), prog
    assert _failed(c, ctrl), ctrl
