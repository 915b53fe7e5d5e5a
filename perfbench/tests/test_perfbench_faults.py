"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU, 64 px) and the rest of a run
is driven with a fault planted in the program, once for each fault the cell
can have.  Each fault must push one compared number over its committed limit
and above the sound run's reading."""

import pytest
import torch

from perfbench.tests.helpers import run_tiny

import mcaq_yolo_tpu_torch.inference as inference
import mcaq_yolo_tpu_torch.train as ptrain


def _over(sound, broken):
    assert not broken["correct"]
    return [k for k, v in broken["checks"].items()
            if v["value"] > v["limit"] and v["value"] > sound["checks"][k]["value"]]


@pytest.fixture(scope="module")
def sound_serve():
    return {w: run_tiny(w) for w in ("n-serve-bs256", "n-serve-bs1")}


@pytest.mark.parametrize("workload", ["n-serve-bs256", "n-serve-bs1"])
def test_serving_answer_altered(workload, sound_serve, monkeypatch):
    real = inference.deployed_program

    def altered(*a, **k):
        out = list(real(*a, **k))
        out[0] = out[0] + 24.0  # every box moved where it is produced
        return tuple(out)

    monkeypatch.setattr(inference, "deployed_program", altered)
    over = _over(sound_serve[workload], run_tiny(workload))
    assert {"det_mismatch_given", "det_box_gap_given"} & set(over), over


def test_serving_half_the_batch(sound_serve, monkeypatch):
    real = inference.deployed_program

    def half(model, images, *a, **k):
        n = images.shape[0] // 2
        out = real(model, images[:n], *a, **k)
        return tuple(o if o.dim() == 0 else torch.cat([o, o]) for o in out)

    monkeypatch.setattr(inference, "deployed_program", half)
    assert _over(sound_serve["n-serve-bs256"], run_tiny("n-serve-bs256"))


@pytest.fixture(scope="module")
def sound_train():
    return run_tiny("m-train-bs64")


def test_train_state_unchanged(sound_train, monkeypatch):
    monkeypatch.setattr(ptrain.Optimizer, "step", lambda self: torch.zeros(()))
    over = _over(sound_train, run_tiny("m-train-bs64"))
    assert {"grad_median_gap", "change_median_gap"} <= set(over), over


def test_train_half_the_batch(sound_train, monkeypatch):
    real = ptrain.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def half(opt, batch, *args, **kw):
            n = batch["image"].shape[0] // 2
            return step(opt, {key: v[:n] for key, v in batch.items()}, *args, **kw)
        return half

    monkeypatch.setattr(ptrain, "make_train_step", make)
    assert _over(sound_train, run_tiny("m-train-bs64"))
