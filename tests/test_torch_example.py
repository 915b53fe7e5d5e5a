"""The port's train example (`examples/train_example_torch.py`) end to end on
the CPU at its own sizes (16 synthetic images, 128 px, 3 epochs, bs 4):
`last.ckpt` written, 3 epochs of history, and the served image's result
with the reference's keys and avg_bits in [2, 8].  One torch thread."""

import importlib.util
import tempfile
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_example_torch", REPO / "examples" / "train_example_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_example_runs_on_the_cpu(one_thread, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = _example().main(["--device", "cpu"])
    assert out["root"].is_absolute() and out["root"].parent == tmp_path.resolve()
    assert out["checkpoint"].is_file()
    assert [h["epoch"] for h in out["history"]] == [0, 1, 2]
    assert (out["root"] / "outputs" / "history.json").is_file()
    res = out["inference"]
    for key in ("detections", "inference_time_ms", "avg_bits", "complexity_map", "bit_map"):
        assert key in res, key
    assert 2.0 <= res["avg_bits"] <= 8.0
    printed = capsys.readouterr().out
    assert "training: {" in printed and "inference: " in printed and "avg_bits" in printed
