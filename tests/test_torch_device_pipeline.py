"""The port's device-resident data pipeline (`data/device_pipeline.py`, here
on the CPU) against the JAX `DevicePipeline` and against the host loader,
on a v2 synthetic dataset written at the letterboxed size (64 px), with
plans and images made from seeds.

Tolerances:
  * clean bank and labels: bitwise equal to the host loader's and to the
    JAX pipeline's;
  * mosaic: bitwise equal to the host mosaic (any random center) and to
    the JAX composite;
  * HSV and affine against cv2 on the host: the bounds
    `tests/test_device_pipeline.py` pins for the JAX pipeline (HSV mean
    |diff| < 1.5 and p99 <= 6 levels; affine mean < 1 and p99 <= 3); against
    the JAX pipeline's float32 arithmetic: within 1 level;
  * augmented loader batches: labels equal to the JAX pipeline's (the same
    draws in the same order), pixels within 1 level;
  * subset indices and a chunked upload: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.data import dataset as jd
from mcaq_yolo_tpu.data import device_pipeline as jdp
from mcaq_yolo_tpu_torch.data import dataset as td
from mcaq_yolo_tpu_torch.data import device_pipeline as tdp

S = 64


class _ScriptedRng:
    """Replays scripted draws so a host augmentation can be forced."""

    def __init__(self, randoms=(), integers=(), uniforms=()):
        self._r, self._i, self._u = list(randoms), list(integers), list(uniforms)

    def random(self):
        return self._r.pop(0)

    def integers(self, lo, hi, size=None):
        v = self._i.pop(0)
        return np.asarray(v) if size is not None else v

    def uniform(self, lo, hi, size=None):
        v = self._u.pop(0)
        return np.asarray(v) if size is not None else v


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpv2")
    data = jd.load_dataset_yaml(jd.make_synthetic_dataset_v2(str(root), n_images=8,
                                                             img_size=S, n_val=4, seed=3))
    tds = td.YOLODataset(data["train"], S, max_boxes=16, cache_images=True)
    jds = jd.YOLODataset(data["train"], S, max_boxes=16, cache_images=True)
    return {"tds": tds, "jds": jds, "pipe": tdp.DevicePipeline(tds, device="cpu"),
            "jpipe": jdp.DevicePipeline(jds)}


def _plan(idxs, mosaic=True, hsv=None, gains=None, s=1.0, tx=0.0, ty=0.0, flip=False):
    B = len(idxs)
    return (np.asarray(idxs, np.int64), np.full(B, mosaic), np.asarray(
        hsv if hsv is not None else np.zeros((B, 4), bool)),
        np.asarray(gains if gains is not None else np.ones((B, 4, 3)), np.float32),
        np.full(B, s, np.float32), np.full(B, tx, np.float32), np.full(B, ty, np.float32),
        np.full(B, flip))


def _port_augment(pipe, plan):
    return tdp.augment_batch(pipe.bank, *map(torch.from_numpy, plan)).numpy()


def _jax_augment(jpipe, plan):
    p = (plan[0].astype(np.int32),) + plan[1:]
    return np.asarray(jpipe._augment(jpipe.bank, *map(jnp.asarray, p)))


def test_clean_bank_and_labels_match_host_and_jax(env):
    pipe, jpipe, tds = env["pipe"], env["jpipe"], env["tds"]
    assert pipe.bank.dtype == torch.uint8 and pipe.bank.device.type == "cpu"
    np.testing.assert_array_equal(pipe.bank.numpy(), np.asarray(jpipe.bank))
    host = td.DataLoader(tds, 4, shuffle=False, drop_last=True)
    dev = pipe.loader(4, shuffle=False, drop_last=True, augment=False)
    for hb, db in zip(host, dev):
        np.testing.assert_array_equal(hb["image"], db["image"].numpy())
        for k in ("gt_boxes", "gt_classes", "gt_mask"):
            np.testing.assert_array_equal(hb[k], db[k])
        assert hb["paths"] == db["paths"]


def test_mosaic_exact_against_host_and_jax(env):
    pipe, jpipe, tds = env["pipe"], env["jpipe"], env["tds"]
    idxs = [0, 3, 5, 1]
    tds.augment, tds.hsv_p = True, 0.0
    try:
        outs = []
        for cx, cy in [(S // 2, S // 2), (S, 3 * S // 2), (3 * S // 2, S)]:
            tds.rng = _ScriptedRng(randoms=[0.9] * 8, integers=[idxs[1:], cx, cy])
            outs.append(tds._mosaic(idxs[0]))
    finally:
        tds.augment, tds.hsv_p, tds.rng = False, 0.5, np.random.default_rng(0)
    for img, boxes, _ in outs[1:]:  # the host mosaic's center cancels
        np.testing.assert_array_equal(outs[0][0], img)
        np.testing.assert_array_equal(outs[0][1], boxes)
    plan = _plan([idxs])
    dev = _port_augment(pipe, plan)[0]
    np.testing.assert_array_equal(outs[0][0], dev)
    np.testing.assert_array_equal(dev, _jax_augment(jpipe, plan)[0])
    boxes, classes = pipe._mosaic_labels(idxs)
    np.testing.assert_allclose(outs[0][1], boxes, atol=1e-5)
    np.testing.assert_array_equal(outs[0][2], classes)


def test_affine_against_cv2_and_jax(env):
    pytest.importorskip("cv2")
    pipe, jpipe, tds = env["pipe"], env["jpipe"], env["tds"]
    img = pipe.bank[0].numpy()
    boxes, classes = pipe.boxes[0], pipe.classes[0]
    s, tx, ty = 1.3, 4.0, -5.0
    tds.augment = True
    try:
        tds.rng = _ScriptedRng(uniforms=[s - 1.0, tx / S, ty / S])
        h_img, h_boxes, _ = tds._affine(img.copy(), boxes.copy(), classes)
    finally:
        tds.augment, tds.rng = False, np.random.default_rng(0)
    plan = _plan([[0, 0, 0, 0]], mosaic=False, s=s, tx=tx, ty=ty)
    d_img = _port_augment(pipe, plan)[0]
    diff = np.abs(h_img.astype(np.int32) - d_img.astype(np.int32))
    assert diff.mean() < 1.0, diff.mean()
    assert np.quantile(diff, 0.99) <= 3
    assert np.abs(d_img.astype(int) - _jax_augment(jpipe, plan)[0].astype(int)).max() <= 1
    d_boxes, _ = pipe._affine_labels(boxes.copy(), classes, s, tx, ty)
    np.testing.assert_allclose(h_boxes, d_boxes, atol=1e-4)
    # shrinking shows the border: cv2's 114
    out = tdp.affine(torch.from_numpy(pipe.bank[1:2].numpy().astype(np.float32)),
                     torch.tensor([0.5]), torch.zeros(1), torch.zeros(1))
    np.testing.assert_array_equal(torch.round(out[0, :4, :4]).numpy(), 114.0)


def test_hsv_against_cv2_and_jax(env):
    pytest.importorskip("cv2")
    pipe, jpipe, tds = env["pipe"], env["jpipe"], env["tds"]
    img = pipe.bank[2].numpy()
    gains = np.asarray([1.01, 1.4, 0.8], np.float32)
    tds.augment = True
    try:
        tds.rng = _ScriptedRng(uniforms=[(gains - 1.0) / np.array([0.015, 0.7, 0.4])])
        h_img = tds._hsv_jitter(img.copy())
    finally:
        tds.augment, tds.rng = False, np.random.default_rng(0)
    d = tdp.hsv_jitter(torch.from_numpy(img.astype(np.float32)), torch.from_numpy(gains))
    d_img = torch.clamp(torch.round(d), 0, 255).to(torch.uint8).numpy()
    diff = np.abs(h_img.astype(np.int32) - d_img.astype(np.int32))
    assert diff.mean() < 1.5, diff.mean()
    assert np.quantile(diff, 0.99) <= 6
    j = np.asarray(jdp._hsv_jitter_device(jnp.asarray(img, jnp.float32), jnp.asarray(gains)))
    assert np.abs(d.numpy() - j).max() <= 1.0


def test_augmented_loader_matches_jax(env):
    pipe, jpipe, tds, jds = env["pipe"], env["jpipe"], env["tds"], env["jds"]
    for ds in (tds, jds):
        ds.augment, ds.mosaic_p, ds.hsv_p = True, 0.5, 0.5
    try:
        port = list(pipe.loader(4, shuffle=True, seed=11))
        ref = list(jpipe.loader(4, shuffle=True, seed=11))
        again = list(pipe.loader(4, shuffle=True, seed=11))
    finally:
        for ds in (tds, jds):
            ds.augment, ds.mosaic_p, ds.hsv_p = False, 0.0, 0.5
    assert len(port) == len(ref) == 2
    for p, j, a in zip(port, ref, again):
        assert p["image"].shape == (4, S, S, 3) and p["image"].dtype == torch.uint8
        for k in ("gt_boxes", "gt_classes", "gt_mask"):
            np.testing.assert_array_equal(p[k], j[k])
        assert p["paths"] == j["paths"]
        assert np.abs(p["image"].numpy().astype(int)
                      - np.asarray(j["image"]).astype(int)).max() <= 1
        np.testing.assert_array_equal(p["image"].numpy(), a["image"].numpy())
        assert (p["gt_boxes"] >= 0).all() and (p["gt_boxes"] <= S).all()


def test_subset_indices_and_chunked_upload(env):
    pipe, tds = env["pipe"], env["tds"]
    sub = [1, 2, 5, 6]
    batch = next(iter(pipe.loader(4, shuffle=False, indices=sub, augment=False)))
    assert batch["paths"] == [tds.img_files[j] for j in sub]
    assert len(pipe.loader(3, indices=sub)) == 1
    assert len(pipe.loader(3, indices=sub, drop_last=False)) == 2
    multi = tdp.DevicePipeline(tds, chunk_bytes=2 * S * S * 3, device="cpu")
    assert len(multi.bank) == len(tds)
    np.testing.assert_array_equal(multi.bank.numpy(), pipe.bank.numpy())
    with pytest.raises(ValueError, match="even"):
        tdp.DevicePipeline(td.YOLODataset(tds.img_dir, S + 1), device="cpu")
