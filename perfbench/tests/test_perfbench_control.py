"""The control — the plain reference one precision below the
configuration's (float8 network convolutions, TF32 for the float32 MCAQ
math and teacher, bfloat16 decode and NMS) put in the program's place —
fails the committed limits of every cell: at a size a test run holds on
the CPU, and at the cell's own size on the card (`gpu`)."""

import importlib

import pytest
import torch

from perfbench import run
from perfbench.tests.helpers import cell, tiny_cell

CELLS = ["n-serve-bs256", "m-train-bs64", "n-serve-bs1", "m-serve-bs256"]


def _control(c, device, seed=246813579):
    mod = importlib.import_module(f"perfbench.drivers.{c['traffic']['driver']}")
    drv = mod.Driver(c["config"], c["traffic"], seed, device, lambda o: None)
    drv.setup()
    drv.window(0.5)
    drv.release()
    prog = drv.check()
    return prog, drv.control()


def _failed(c, numbers):
    return [k for k, lim in c["limits"].items() if not k.startswith("_") and numbers[k] > lim]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_a_small_size(workload):
    torch.set_num_threads(2)
    c = tiny_cell(workload)
    _, ctrl = _control(c, torch.device("cpu"))
    assert _failed(c, ctrl), ctrl


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.cache_env()
    c = cell(workload)
    prog, ctrl = _control(c, torch.device("cuda", 0))
    assert not _failed(c, prog), prog
    assert _failed(c, ctrl), ctrl
