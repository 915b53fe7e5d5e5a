"""The port's detection evaluation (`utils/evaluation.py`) against the JAX
package's on random detections made from seeds: every returned number
within 1e-12 (the same NumPy arithmetic)."""

import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.utils import evaluation as je
from mcaq_yolo_tpu_torch.utils import evaluation as te


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(2, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _images(seed, n_images=6, nc=5):
    """Per-image targets and predictions: jittered copies of the targets
    (some with the wrong class), plus false positives and a hallucinated
    class."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(n_images):
        m = int(rng.integers(0 if i == 0 else 1, 6))
        tb, tc = _boxes(rng, m), rng.integers(0, nc, m)
        keep = rng.random(m) < 0.8
        pb = tb[keep] + rng.normal(0, 3, (int(keep.sum()), 4)).astype(np.float32)
        pc = np.where(rng.random(int(keep.sum())) < 0.85, tc[keep], rng.integers(0, nc + 1))
        k = int(rng.integers(0, 4))
        pb = np.concatenate([pb, _boxes(rng, k)])
        pc = np.concatenate([pc, rng.integers(0, nc + 2, k)])
        ps = rng.random(len(pb)).astype(np.float32)
        preds.append({"boxes": pb, "scores": ps, "classes": pc})
        targets.append({"boxes": tb, "classes": tc})
    return preds, targets


def _assert_nested_close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_nested_close(a[k], b[k])
    else:
        assert a == pytest.approx(b, abs=1e-12)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("method", ["voc", "coco"])
@pytest.mark.parametrize("iou", [0.3, 0.5, 0.75])
def test_compute_map(seed, method, iou):
    preds, targets = _images(seed)
    _assert_nested_close(te.compute_map(preds, targets, iou, method),
                         je.compute_map(preds, targets, iou, method))


@pytest.mark.parametrize("seed", range(4))
def test_compute_map50_95(seed):
    preds, targets = _images(seed + 10)
    _assert_nested_close(te.compute_map50_95(preds, targets),
                         je.compute_map50_95(preds, targets))


def test_helpers_and_edge_cases():
    rng = np.random.default_rng(3)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    np.testing.assert_allclose(te._box_iou_np(a, b), je._box_iou_np(a, b), atol=1e-12)
    assert te._box_iou_np(a[:0], b).shape == (0, 5)
    r, p = np.sort(rng.random(9)), rng.random(9)
    for method in ("voc", "coco"):
        assert te._ap_from_pr(r, p, method) == pytest.approx(je._ap_from_pr(r, p, method),
                                                             abs=1e-12)
    assert te.compute_map([], [])["map"] == je.compute_map([], [])["map"] == 0.0
    with pytest.raises(ValueError):
        te.compute_map([{}], [])

    B, M, D = 3, 6, 10
    batch = {"gt_boxes": rng.random((B, M, 4)).astype(np.float32),
             "gt_classes": rng.integers(0, 4, (B, M)).astype(np.int32),
             "gt_mask": rng.random((B, M)) < 0.5}
    det = (rng.random((B, D, 4)).astype(np.float32), rng.random((B, D)).astype(np.float32),
           rng.integers(0, 4, (B, D)).astype(np.int32), rng.random((B, D)) < 0.6)
    for got, ref in ((te.extract_targets_per_image(batch), je.extract_targets_per_image(batch)),
                     (te.detections_to_numpy(*map(torch.from_numpy, det)),
                      je.detections_to_numpy(*det))):
        assert len(got) == len(ref) == B
        for g, r_ in zip(got, ref):
            assert g.keys() == r_.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], r_[k])


def test_evaluate_mcaq_yolo_matches(tmp_path):
    """The loop on the same fixed detections: every number but the
    latencies equal, and the JSON written."""
    preds, targets = _images(42, n_images=8)
    D = max(len(p["boxes"]) for p in preds)

    def padded(items):
        B = len(items)
        out = (np.zeros((B, D, 4), np.float32), np.zeros((B, D), np.float32),
               np.zeros((B, D), np.int32), np.zeros((B, D), bool))
        for i, p in enumerate(items):
            n = len(p["boxes"])
            out[0][i, :n], out[1][i, :n], out[2][i, :n], out[3][i, :n] = (
                p["boxes"], p["scores"], p["classes"], True)
        return out

    M = max(len(t["boxes"]) for t in targets)
    loader = []
    for s in (0, 4):
        tb = np.zeros((4, M, 4), np.float32)
        tc = np.zeros((4, M), np.int32)
        tm = np.zeros((4, M), bool)
        for i, t in enumerate(targets[s:s + 4]):
            n = len(t["boxes"])
            tb[i, :n], tc[i, :n], tm[i, :n] = t["boxes"], t["classes"], True
        loader.append({"image": np.full((4, 8, 8, 3), s, np.uint8), "gt_boxes": tb,
                       "gt_classes": tc, "gt_mask": tm})
    bits = {0: 4.25, 4: 5.5}

    def forward(images):
        s = int(np.asarray(images)[0, 0, 0, 0])
        return padded(preds[s:s + 4]) + (bits[s],)

    got = te.evaluate_mcaq_yolo(forward, loader, output_json=str(tmp_path / "e.json"))
    ref = je.evaluate_mcaq_yolo(forward, loader)
    for k in ref:
        if not k.startswith("latency"):
            _assert_nested_close(got[k], ref[k])
    assert (tmp_path / "e.json").exists() and got["num_images"] == 8
