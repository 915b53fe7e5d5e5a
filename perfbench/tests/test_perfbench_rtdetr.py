"""Cell `rtdetr-l-serve-bs256` (RT-DETR-L): its driver's yardsticks at the
cell's size, and the cell run on the CPU at 160 px (525 anchors, at least
the 300 queries) from its own files (`configs/rtdetr-l-mcaq.json`,
`traffic/serve_batch_device_rtdetr.json`, `drivers/serve_batch_rtdetr.py`,
`reference/rtdetr.py`, `limits/` and the five new readers); the control
(the reference one precision below: float8 convolutions, linears and
attention products, TF32 MCAQ math, bfloat16 sampling locations and
post-process) fails the cell's limits, on the CPU at 160 px and on the card
(`gpu`) at the cell's size; so do bfloat16 sampling locations alone, by the
sampling's own number `deform_rel_err_given`; a selection moved by one rank
fails `query_mismatch_given`, and the selection numbers count ranks and
sets."""

import pytest
import torch

from perfbench import run
from perfbench import yardsticks as y
from perfbench.drivers import serve_batch_rtdetr as d
from perfbench.reference import rtdetr as rr
from perfbench.tests.helpers import run_tiny, tiny_cell

IMG = 160


def test_flops_and_the_sampling_bound():
    convs, products = rr.network_flops(80, 640)
    assert abs((convs + products) / 109.54e9 - 1) < 0.005
    assert d.flops_per_image(80, 640) == convs + products
    # per image and layer 4.80 MB: the bf16 value map (8400 x 256), float32
    # locations and weights of 28,800 points, the bf16 output (300 x 256)
    assert d.deform_bytes(1, 640) == 6 * (8400 * 256 * 2 + 28_800 * 3 * 4 + 300 * 256 * 2)
    assert d.deform_bytes(256, 640) == 7_372_800_000
    assert d.deform_ops(256) == 256 * 6 * 28_800 * 32 * 10  # 14.2 GFLOP
    assert d.deform_bound_s(256, 640) == pytest.approx(7.3728e9 / y.HBM_BYTES_PER_S, rel=1e-12)
    assert abs(d.deform_bound_s(256, 640) * 1e3 - 2.20) < 0.005


def test_rtdetr_cell_runs_correct_on_the_cpu():
    res = run_tiny("rtdetr-l-serve-bs256", trace=True, c=tiny_cell("rtdetr-l-serve-bs256", IMG))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res["checks"]
    assert res["metrics"]["deform_attn_calls.serve"]["value"] == 6.0
    assert res["metrics"]["bn_silu_launches.serve"]["value"] == 0.0  # no kernel on the CPU
    assert "deform_ms.serve" not in res["metrics"]  # no device kernels on the CPU


def _driver(c, device, seed=246813579):
    drv = d.Driver(c["config"], c["traffic"], seed, device, lambda o: None)
    drv.setup()
    drv.window(0.5)
    drv.release()
    return drv


def _failed(c, numbers):
    return [k for k, lim in c["limits"].items() if not k.startswith("_") and numbers[k] > lim]


def test_control_and_a_moved_selection_fail_at_a_small_size():
    torch.set_num_threads(2)
    c = tiny_cell("rtdetr-l-serve-bs256", IMG)
    drv = _driver(c, torch.device("cpu"))
    prog = drv.check()
    assert not _failed(c, prog), prog
    assert _failed(c, drv.control())
    # the program's selection with its first two ranks of image 0 swapped
    sel = drv.cap.selection[0].clone()
    sel[0, [0, 1]] = sel[0, [1, 0]]
    drv.cap.selection[0] = sel
    moved = drv.numbers({**drv.cap.call(0), "dets": []})
    assert moved["query_mismatch_given"] == pytest.approx(2 / sel.numel())
    assert "query_mismatch_given" in _failed(c, {**prog, **moved})


def test_bf16_locations_alone_fail_the_sampling_number():
    torch.set_num_threads(2)
    c = tiny_cell("rtdetr-l-serve-bs256", IMG)
    drv = _driver(c, torch.device("cpu"))
    assert not _failed(c, drv.check())
    assert _failed(c, drv.control("locations")) == ["deform_rel_err_given"]
    with pytest.raises(ValueError):
        drv.control("half")


def test_selection_numbers_count_ranks_and_sets():
    r = torch.arange(12).reshape(2, 6)
    swapped = r[:, [1, 0, 2, 3, 4, 5]]
    replaced = r.clone()
    replaced[1, 5] = 40
    assert d.selection_mismatch(swapped, r) == pytest.approx(4 / 12)
    assert d.selection_set_mismatch(swapped, r) == 0.0
    assert d.selection_set_mismatch(replaced, r) == pytest.approx(1 / 12)
    assert d.selection_set_mismatch(r[:, :5], r) == 1.0


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.cache_env()
    c = run.cell("rtdetr-l-serve-bs256")
    drv = _driver(c, torch.device("cuda", 0))
    prog = drv.check()
    assert not _failed(c, prog), prog
    assert _failed(c, drv.control())
    assert _failed(c, drv.control("locations")) == ["deform_rel_err_given"]
