"""The port's evidence scripts and the helpers only they call, against the
JAX reference on the CPU, on the same numpy-seeded inputs.

Tolerances:
  * `quality_assemble.assemble`, `permute_bit_map`, `bootstrap_ci` and
    `per_image_ap`: exactly equal (the same NumPy / pure-Python code);
  * `analyze_complexity_correlation`: 1e-12 (scipy on the same float64);
  * `decode_predictions`: boxes 1e-5 abs in feature units (pixels over the
    anchor's stride: the DFL softmax's rounding, which the stride scales by
    up to 32 in pixels), scores 1e-6 abs;
  * NMS on tie-free scores: the same valid set and classes, boxes 1e-5;
  * `evaluate_quantization_impact` / `quantization_sensitivity`: 1e-5
    relative (float32 means of the same squares);
  * the external-bit-map forward: the model's own maps give the normal
    forward's raw maps bitwise (plain path); against JAX on carried
    weights at 64 px, 2e-4 on >= 99.9% of elements (the slice's class).
`quality_evidence.run` is port-only: its table has the reference
evidence's key set, and its fail-fast errors are JAX's.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.models import MCAQYOLO as JaxMCAQYOLO
from mcaq_yolo_tpu.models.yolo import decode_predictions as jax_decode_predictions
from mcaq_yolo_tpu.ops import nms as jnms
from mcaq_yolo_tpu.scripts import m3_permutation as jm3
from mcaq_yolo_tpu.scripts import m4_variation_gain as jm4
from mcaq_yolo_tpu.scripts import quality_assemble as jqa
from mcaq_yolo_tpu.scripts import quality_evidence as jqe
from mcaq_yolo_tpu.utils import evaluation as jev
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import decode_predictions
from mcaq_yolo_tpu_torch.ops import nms as tnms
from mcaq_yolo_tpu_torch.scripts import m3_permutation as m3
from mcaq_yolo_tpu_torch.scripts import m4_variation_gain as m4
from mcaq_yolo_tpu_torch.scripts import quality_assemble as qa
from mcaq_yolo_tpu_torch.scripts import quality_evidence as qe
from mcaq_yolo_tpu_torch.utils import evaluation as tev

REPO = Path(__file__).resolve().parents[1]
R5 = REPO / "evidence" / "r5"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the gate's six workers on eight cores,
    each with eight OpenMP threads, slow these many small CPU ops ~80x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quality_assemble_equals_jax():
    paths = [str(R5 / f"quality_seed{s}.json") for s in range(3)]
    assert qa.assemble(paths) == jqa.assemble(paths)
    assert qa._mean_std([0.5, None, 0.25]) == jqa._mean_std([0.5, None, 0.25])


@pytest.mark.parametrize("mode", ["mcaq", "permuted", "inverted"])
def test_permute_bit_map_equals_jax(mode):
    m = np.random.default_rng(1).integers(2, 9, (10, 10)).astype(np.float32)
    out = m3.permute_bit_map(m, mode, seed=7)
    np.testing.assert_array_equal(out, jm3.permute_bit_map(m, mode, seed=7))
    assert sorted(out.reshape(-1)) == sorted(m.reshape(-1))  # histogram kept
    with pytest.raises(ValueError):
        m3.permute_bit_map(m, "shuffled", 0)


def test_bootstrap_ci_and_per_image_ap_equal_jax():
    v = np.random.default_rng(2).normal(0, 1, 37)
    assert m4.bootstrap_ci(v, reps=300, seed=3) == jm4.bootstrap_ci(v, reps=300, seed=3)
    assert m4.bootstrap_ci(np.zeros(0)) == pytest.approx(jm4.bootstrap_ci(np.zeros(0)),
                                                         nan_ok=True)
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 50, (6, 2))
    gt = {"boxes": np.concatenate([xy, xy + rng.uniform(5, 20, (6, 2))], 1),
          "classes": rng.integers(0, 3, 6)}
    pred = {"boxes": gt["boxes"] + rng.normal(0, 2, (6, 4)),
            "scores": rng.uniform(0, 1, 6), "classes": gt["classes"].copy()}
    pred["classes"][0] = (pred["classes"][0] + 1) % 3
    for thr in (0.5, 0.75):
        ap = m4.per_image_ap(pred, gt, thr)
        assert ap == jm4.per_image_ap(pred, gt, thr)
    assert 0.0 < m4.per_image_ap(pred, gt) < 1.0


def test_analyze_complexity_correlation_matches_jax():
    rng = np.random.default_rng(5)
    c = rng.uniform(0, 1, 40)
    s = 0.5 * c + rng.normal(0, 0.2, 40)
    out, ref = tev.analyze_complexity_correlation(c, s), jev.analyze_complexity_correlation(c, s)
    assert out.keys() == ref.keys() and out["n"] == ref["n"] == 40
    for k in ("pearson_r", "pearson_p", "spearman_r", "spearman_p"):
        assert out[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12)


def _raw_maps(size, nc, seed, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 2, (batch, size // s, size // s, 64 + nc)).astype(np.float32)
            for s in (8, 16, 32)]


def test_decode_predictions_matches_jax():
    maps = _raw_maps(64, 5, seed=6)
    ref = [np.asarray(a) for a in jax_decode_predictions([jnp.asarray(m) for m in maps], 5)]
    out = [a.numpy() for a in decode_predictions([torch.from_numpy(m) for m in maps], 5)]
    assert [o.shape for o in out] == [r.shape for r in ref]
    # boxes in feature units (pixels / stride): the DFL softmax's rounding
    # is scaled by strides up to 32 in pixels
    np.testing.assert_allclose(out[0] / out[3], ref[0] / ref[3], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[1], ref[1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_array_equal(out[3], ref[3])


def _same_detections(out, ref):
    """Same valid set and classes, scores 1e-6, boxes 1e-5; returns the
    number of valid detections."""
    boxes, scores, classes, valid = [np.asarray(a) for a in out]
    rb, rs, rc, rv = [np.asarray(a) for a in ref]
    np.testing.assert_array_equal(valid, rv)
    np.testing.assert_array_equal(classes[valid], rc[rv])
    np.testing.assert_allclose(scores[valid], rs[rv], atol=1e-6, rtol=0)
    np.testing.assert_allclose(boxes[valid], rb[rv], atol=1e-5, rtol=0)
    return int(valid.sum())


@pytest.mark.parametrize("class_agnostic", [False, True])
@pytest.mark.parametrize("conf,pre_topk", [(0.001, 1024), (0.3, 64)])
def test_batched_nms_paths_match_jax(class_agnostic, conf, pre_topk):
    """Decoded boxes and scores of seeded raw maps (continuous, so tie-free):
    `batched_nms`, `batched_nms_from_best`, and the one-image
    `non_max_suppression` / `nms_from_best`, class-aware and agnostic."""
    maps = _raw_maps(128, 4, seed=7)
    boxes, scores, _, _ = decode_predictions([torch.from_numpy(m) for m in maps], 4)
    jb, js = jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy())
    kw = dict(conf_threshold=conf, iou_threshold=0.45, max_det=100, pre_topk=pre_topk,
              class_agnostic=class_agnostic)
    n = _same_detections(tnms.batched_nms(boxes, scores, **kw),
                         jnms.batched_nms(jb, js, **kw))
    assert n > 0
    best, cls = scores.max(-1)
    cls = cls.to(torch.int32)
    _same_detections(tnms.batched_nms_from_best(boxes, best, cls, **kw),
                     jnms.batched_nms_from_best(jb, jnp.asarray(best.numpy()),
                                                jnp.asarray(cls.numpy()), **kw))
    _same_detections(tnms.non_max_suppression(boxes[1], scores[1], **kw),
                     jnms.non_max_suppression(jb[1], js[1], **kw))
    _same_detections(tnms.nms_from_best(boxes[0], best[0], cls[0], **kw),
                     jnms.nms_from_best(jb[0], jnp.asarray(best[0].numpy()),
                                        jnp.asarray(cls[0].numpy()), **kw))


def _seeded_forward(seed):
    """A stand-in forward: raw maps that depend on the images, the quantize
    flag and the temperature, identical for both packages."""
    def maps(images, temperature, quantize):
        key = int(np.asarray(images).sum()) % 1000 + 10 * int(quantize) + int(100 * temperature)
        return _raw_maps(64, 3, seed=seed + key, batch=np.asarray(images).shape[0])
    return maps


def test_quantization_impact_and_sensitivity_match_jax():
    rng = np.random.default_rng(8)
    loader = [{"image": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)} for _ in range(3)]
    fwd = _seeded_forward(9)
    t_div = tev.evaluate_quantization_impact(
        lambda im: [torch.from_numpy(m) for m in fwd(im, 1.0, False)],
        lambda im: [torch.from_numpy(m) for m in fwd(im, 1.0, True)], loader, max_batches=2)
    j_div = jev.evaluate_quantization_impact(
        lambda im: [jnp.asarray(m) for m in fwd(im, 1.0, False)],
        lambda im: [jnp.asarray(m) for m in fwd(im, 1.0, True)], loader, max_batches=2)
    assert t_div.keys() == j_div.keys() and len(t_div["per_image"]) == 4
    for k in ("mean_divergence", "std_divergence", "max_divergence"):
        assert t_div[k] == pytest.approx(j_div[k], rel=1e-5)
    np.testing.assert_allclose(t_div["per_image"], j_div["per_image"], rtol=1e-5)

    images = loader[0]["image"]
    out = tev.quantization_sensitivity(
        lambda im, temperature, quantize: [torch.from_numpy(m)
                                           for m in fwd(im, temperature, quantize)],
        images, temperature=0.1)
    ref = jev.quantization_sensitivity(
        lambda v, im, temperature, quantize, return_aux: [
            jnp.asarray(m) for m in fwd(im, temperature, quantize)],
        None, images, temperature=0.1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


def test_external_bit_maps_identity_is_the_normal_forward_and_matches_jax():
    images = np.random.default_rng(10).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    port = MCAQYOLO(num_classes=4, bit_mapping="linear", device="cpu", seed=3)
    x = torch.from_numpy(images)
    raw, aux = port(x, temperature=1.0, quantize=True)
    for a, b in zip(raw, m3.apply_external_bit_maps(port, x, aux["bit_map"])):
        assert torch.equal(a, b)  # bitwise: the same code with the same maps

    # permuted maps (the M3 arm) through both packages on carried weights
    maps = [np.stack([m3.permute_bit_map(m[i], "permuted", i) for i in range(2)])
            for m in (b.numpy() for b in aux["bit_map"])]
    out = m3.apply_external_bit_maps(port, x, [torch.from_numpy(m) for m in maps])
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=4, bit_mapping="linear")
    ref = jax.jit(lambda v, im, mp: jm3.apply_external_bit_maps(jm, v, im, mp))(
        to_jax_variables(port), jnp.asarray(images), [jnp.asarray(m) for m in maps])
    for o, r in zip(out, ref):
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == r.shape
        close = np.isclose(o, r, atol=2e-4, rtol=2e-4)
        assert close.mean() >= 0.999, (close.mean(), np.abs(o - r).max())


def test_quality_evidence_fail_fast_errors_match_jax(tmp_path):
    cases = [dict(arms="c"), dict(arms="b", kd_epochs=2),
             dict(arms="am"), dict(arms="c", fp_ckpt=str(tmp_path / "none.ckpt"))]
    for kw in cases:
        with pytest.raises(Exception) as ref:
            jqe.run(root=str(tmp_path / "j"), **kw)
        with pytest.raises(type(ref.value)) as out:
            qe.run(root=str(tmp_path / "t"), device="cpu", **kw)
        assert str(out.value) == str(ref.value)
    assert not (tmp_path / "t").exists()  # nothing written before the checks


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_quality_evidence_run_has_the_reference_table(tmp_path):
    """All four arms at 64 px for an epoch or two on the CPU: the table has
    exactly the key set of the reference's seed-0 evidence, arms' sub-keys
    included, and each arm's numbers are in range."""
    table = qe.run(img_size=64, n_images=8, n_val=4, batch_size=4, epochs=2, fp_epochs=1,
                   arms="abcm", root=str(tmp_path), device="cpu")
    ref = json.loads((R5 / "quality_seed0.json").read_text())
    assert _key_tree(json.loads(json.dumps(table))) == _key_tree(ref)  # as written
    assert table["config"] == dict(ref["config"], img_size=64, epochs=2, fp_epochs=1,
                                   n_images=8, n_val=4)
    assert table["fp_trained_arm"]["avg_bits"] == 32.0
    assert 2.0 <= table["mcaq_trained_arm"]["avg_bits"] <= 8.0
    assert sum(table["mcaq_trained_arm"]["bit_histogram"].values()) > 0
    assert table["matched_ptq_arm"]["avg_bits"] == table["matched_ptq_arm"]["pinned_bits"]
    assert np.isfinite(table["raw_map_divergence"]["mean_divergence"])
    assert (tmp_path / "train_fp" / "last.ckpt").exists()
    assert (tmp_path / "train_mcaq" / "last.ckpt.json").exists()
