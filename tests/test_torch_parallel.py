"""The port's multi-device training and serving (`parallel/`, `training.parallel:
dp | fsdp`, `Predictor(data_parallel=True)`) on the CPU: two gloo ranks
(`tests/torch_parallel_worker.py`, spawned once for the module through a
file store in a temporary directory) against the port at one rank on the
same global batch, and against the JAX package's sharded program on a
2-device mesh of the CPU devices that `tests/conftest.py` forces.  Small
size: yolov8n, 96 px, nc 4, morphology downsample 2, global batch 4 (2 rows
per rank): the sizes of the single-device parity tests, whose morphology
maps hold no Canny ties at these seeds (at 64 px the 2x2 P5 map does, and a
tie moves a tile's complexity with any rounding, the thread count's too).

Tolerances:
  * 2 ranks against 1 rank (the N-rank program is the one-device program
    on the global batch): BatchNorm2d / BatchNorm1d outputs, gradients and
    running statistics, the quantizer's EMA min/max, histogram, ranges and
    output in the minmax, percentile and entropy modes, the detection
    loss's terms (its global target-score sum) and gradients, and the
    whole step's avg_bits, within rtol 1e-5 (the JAX package's own DP
    bound, `tests/test_parallel.py:51`); mse's range within 1e-5 of the
    largest |x| (its error sums are taken per rank); the whole step's loss
    terms within 1e-5 relative, its gradients within 1e-4 relative L2 per
    group, its BatchNorm statistics within 1e-4 of each array's largest
    magnitude (sync-BN sums in another order than `F.batch_norm`: measured
    1.05e-5, 6.6e-5 and 2.3e-6 relative for the three); DP serving's
    detections and maps and distributed `evaluate`'s mAP equal, avg_bits
    within 1e-6 relative (a mean over the ranks' means);
  * 2 port ranks against JAX's 2-device program: the whole step's loss
    terms within 1e-3 relative and its gradients within 1e-2 relative L2 per
    group (the port-against-JAX class of tests/test_torch_train.py:
    convolution rounding moves a few features across a quantization step),
    for 'dp' and 'fsdp'; DP
    serving with the same detection counts and classes and confidences
    within JAX's own bound (rtol 2e-5, atol 2e-6, `tests/test_parallel.py
    :171`); evaluate's mAP within 1e-6 and avg_bits within 1e-6 relative
    (the class of tests/test_torch_trainer_loop.py);
  * the FSDP rule: `fsdp_spec` equal to JAX's on JAX's own cases, and
    `shard_fraction` of the port's yolov8n train state equal to JAX's at
    mesh sizes 2 and 8, on shapes alone; every parameter the rule shards is
    a DTensor after placement and no other is;
  * resume: a 2-rank 'fsdp' checkpoint reloads into a fresh 2-rank Trainer
    and saves back byte-identically, and both go on with equal steps; it
    loads into the one-rank port and through the JAX Trainer's
    `load_checkpoint` with every leaf bitwise equal.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from mcaq_yolo_tpu.inference import Predictor as JaxPredictor
from mcaq_yolo_tpu.models import MCAQYOLO as JaxMCAQYOLO
from mcaq_yolo_tpu.models import YOLOv8 as JaxYOLOv8
from mcaq_yolo_tpu.models.losses import MCAQYOLOLoss as JaxLoss
from mcaq_yolo_tpu.models.losses import kd_feature_loss as jax_kd_feature_loss
from mcaq_yolo_tpu.parallel import fsdp as jfsdp
from mcaq_yolo_tpu.parallel import mesh as jmesh
from mcaq_yolo_tpu.train import Trainer as JaxTrainer
from mcaq_yolo_tpu.train import TrainState, make_eval_step, weight_decay_mask
from mcaq_yolo_tpu.utils import evaluation as jeval
from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
from mcaq_yolo_tpu_torch.parallel import fsdp
from mcaq_yolo_tpu_torch.train import Trainer, make_eval_step as port_eval_step
from mcaq_yolo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint, write_msgpack

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_worker as worker  # noqa: E402

IMG, NC, B, MB, DS = worker.IMG, worker.NC, worker.B, worker.MB, worker.DOWNSAMPLE
WORKER = Path(__file__).with_name("torch_parallel_worker.py")
REPO = Path(__file__).resolve().parents[1]


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err, scale = np.abs(a - b).max(initial=0.0), max(np.abs(b).max(initial=0.0), 1e-30)
    assert err <= rel * scale, f"max |diff| {err:.3g} > {rel} x {scale:.3g}"


def _group_l2(got, ref, rel):
    """Relative L2 error of the gradient per top-level group."""
    assert set(got) == set(ref)
    for group in ref:
        a = np.concatenate([g.ravel() for _, g in _leaves(got[group])])
        b = np.concatenate([g.ravel() for _, g in _leaves(ref[group])])
        if not np.any(b):  # the analyzer, unused by the constant mapper
            assert not np.any(a), group
            continue
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= rel, f"{group}: relative L2 error {err:.3g}"


# ---------------------------------------------------------------------------
# One spawn of two ranks for the module; the one-rank port and JAX meanwhile
# ---------------------------------------------------------------------------


def _inputs(work: Path) -> dict:
    """Seeded student weights and two train batches labelled with their own
    top detections (a random detector finds no foreground in random boxes);
    for serving and evaluate the same weights with eval bit maps spread
    over several widths, and val batches labelled likewise; the teacher and
    the Predictor's checkpoint."""
    rng = np.random.default_rng(3)
    model = MCAQYOLO(num_classes=NC, morph_downsample=DS, device="cpu", seed=0)
    train_images = rng.integers(0, 255, (2 * B, IMG, IMG, 3), np.uint8)
    batches = _labelled(model, train_images, [(0, 4), (4, 8)])
    student = to_jax_variables(model)
    _spread_bits(model, train_images)
    served = to_jax_variables(model)
    teacher = to_jax_variables(YOLOv8("yolov8n", NC, device="cpu", seed=1))
    teacher_path = work / "teacher.msgpack"
    teacher_path.write_bytes(write_msgpack(teacher))
    ckpt = work / "serve.ckpt"
    save_checkpoint(ckpt, served, {
        "variant": "yolov8n", "num_classes": NC, "img_size": IMG,
        "config": {"quantization": {"bit_mapping": "mlp", "monotone_param": "softplus"},
                   "morphology": {"downsample": DS}}})
    # val: two batches the 2-rank mesh splits, then a ragged one it cannot
    val_images = rng.integers(0, 255, (11, IMG, IMG, 3), np.uint8)
    constant = MCAQYOLO(num_classes=NC, morph_downsample=DS, bit_mapping="constant",
                        device="cpu", seed=0)
    return {"batches": batches, "student": student, "teacher": teacher,
            "constant_student": to_jax_variables(constant),
            "teacher_path": str(teacher_path), "predictor_ckpt": str(ckpt),
            "predictor_images": rng.integers(0, 255, (11, IMG, IMG, 3), np.uint8),
            "eval_weights": served,
            "val_batches": _labelled(model, val_images, [(0, 4), (4, 8), (8, 11)])}


def _spread_bits(model, images):
    """The bit mapper's BatchNorm statistics from its own complexity maps
    and its last layer steepened (as `tests/test_torch_trainer_loop.py`
    does), so the eval bit maps spread over widths."""
    import torch.nn.functional as F

    from mcaq_yolo_tpu_torch.models.yolo import images_to_nchw

    mapper = model.bit_mapper
    with torch.no_grad():
        feats = model.backbone(images_to_nchw(torch.from_numpy(images), torch.float32))
        c = torch.cat([model.complexity_analyzer(f.permute(0, 2, 3, 1)).reshape(-1)
                       for f in feats]).clamp(0.0, 1.0)[:, None]
        h = torch.cat([c, c ** 2, torch.log1p(c)], dim=-1)
        for i in range(mapper.n_hidden):
            h = mapper._dense(i)(h)
            bn = getattr(mapper, f"BatchNorm_{i}")
            bn.running_mean.copy_(h.mean(dim=0))
            bn.running_var.copy_(h.var(dim=0, unbiased=False))
            h = F.leaky_relu(bn(h), 0.05)
        last = mapper._dense(mapper.n_hidden)
        last.theta.copy_(torch.log(torch.expm1(F.softplus(last.theta) * 50.0)))


def _labelled(model, images, spans, per_image: int = 3):
    """Batches of `images` (one per (lo, hi) span) labelled with the
    one-rank port's own top detections, so the loss has foreground and the
    mAP moves with every detection."""
    boxes, scores, classes, valid, _ = port_eval_step(model, NC)(torch.from_numpy(images), 1.0)
    out = []
    for lo, hi in spans:
        gt_boxes = np.zeros((hi - lo, MB, 4), np.float32)
        gt_classes = np.zeros((hi - lo, MB), np.int32)
        gt_mask = np.zeros((hi - lo, MB), bool)
        for j, i in enumerate(range(lo, hi)):
            order = np.argsort(-np.where(valid[i].numpy(), scores[i].numpy(), -1))[:per_image]
            gt_boxes[j, :per_image] = boxes[i][order].numpy()
            gt_classes[j, :per_image] = classes[i][order].numpy()
            gt_mask[j, :per_image] = True
        out.append({"image": images[lo:hi], "gt_boxes": gt_boxes, "gt_classes": gt_classes,
                    "gt_mask": gt_mask})
    return out


def _jax_tx():
    """The JAX Trainer's optimizer chain (clip, AdamW on a schedule, the
    decay mask): what its train state holds."""
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(lambda step: 1e-3, mask=lambda p: weight_decay_mask(p, False)))


def _jax_step(inputs, settings, mode):
    """The JAX train step's loss terms, gradients and statistics on the
    first global batch, its batch split over make_mesh(2) and the state
    replicated ('dp') or sharded by the FSDP rule ('fsdp')."""
    mesh = jmesh.make_mesh(2)
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=NC, morph_downsample=DS,
                     bit_mapping="constant")
    teacher = JaxYOLOv8("yolov8n", NC)
    loss_obj = JaxLoss(NC, 4.0)
    v, tv = _np(inputs["constant_student"]), _np(inputs["teacher"])
    place = (lambda t: jfsdp.fsdp_shard(t, mesh)) if mode == "fsdp" else \
        (lambda t: jmesh.replicate(mesh, t))
    v, tv = place(v), place(tv)
    batch = jmesh.shard_batch(mesh, {k: jnp.asarray(a)
                                     for k, a in inputs["batches"][0].items()})
    lw, temp, target = settings["weights"], settings["temperature"], settings["target_bits"]

    def loss_fn(params, v, tv, batch):  # mcaq_yolo_tpu/train.py:97-137
        (raw, aux), upd = jm.apply({**v, "params": params}, batch["image"], temperature=temp,
                                   quantize=False, training=True,
                                   mutable=["batch_stats", "quant_stats"])
        tmaps = teacher.apply(tv, batch["image"])
        aux["kd_feature_loss"] = jax_kd_feature_loss(
            aux["quantized_features"], teacher.apply(tv, batch["image"], method="features"))
        total, d = loss_obj(raw, batch, aux, teacher_maps=tmaps,
                            mapper_params=params.get("bit_mapper"),
                            loss_weights={"detection": 1.0, **lw}, target_bits=target)
        return total, (d, upd, aux["avg_bits"])

    (_, (d, upd, avg_bits)), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v, tv, batch)
    return {"terms": _np(d), "stats": _np(upd), "grads": _np(g), "avg_bits": float(avg_bits)}


def _jax_predictor(ckpt, images):
    """JAX's data-parallel Predictor on a 2-device mesh (its `make_mesh()`
    takes every device: it is shown two).  Its restore overlays the
    checkpoint on a template of the checkpoint's own tree instead of an
    eager `model.init` (~70 s on this CPU): every leaf comes from the
    checkpoint either way."""
    from mcaq_yolo_tpu.utils.model_utils import tolerant_restore

    def load_model(self, path):
        tree = serialization.msgpack_restore(Path(path).read_bytes())
        return tolerant_restore(jax.tree_util.tree_map(jnp.asarray, tree), path)

    devices = jax.devices()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a: devices[:2])
        mp.setattr(JaxPredictor, "_load_model", load_model)
        pred = JaxPredictor(ckpt, num_classes=NC, variant="yolov8n", img_size=IMG,
                            warmup=False, data_parallel=True)
        assert pred.mesh is not None and pred.mesh.devices.size == 2
        return pred.predict_batch(list(images), batch_size=5)


def _jax_evaluate(inputs, temperature):
    """JAX `Trainer.evaluate`'s loop (train.py:786-815) over the same val
    batches at Stage 3: a batch the 2-device mesh divides is sharded."""
    mesh = jmesh.make_mesh(2)
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=NC, morph_downsample=DS)
    step = make_eval_step(jm, NC)
    variables = jmesh.replicate(mesh, _np(inputs["eval_weights"]))
    predictions, targets, bits = [], [], []
    for batch in inputs["val_batches"]:
        images = jnp.asarray(batch["image"])
        if images.shape[0] % 2 == 0:
            images = jmesh.shard_batch(mesh, {"image": images})["image"]
        b, s, c, v, avg_bits = jax.device_get(step(variables, images,
                                                   jnp.float32(temperature), quantize=True))
        predictions.extend(jeval.detections_to_numpy(b, s, c, v))
        targets.extend(jeval.extract_targets_per_image(batch))
        bits.append(float(avg_bits))
    return {"map50": jeval.compute_map(predictions, targets, 0.5)["map"],
            "map50_95": jeval.compute_map50_95(predictions, targets)["map50_95"],
            "avg_bits": float(np.mean(bits))}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inputs = _inputs(work)
        with open(work / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        env_vars = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        procs = [subprocess.Popen([sys.executable, str(WORKER), str(work), str(r), "2"],
                                  env=env_vars, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            single = worker.run_all(inputs, work / "single", None)
            settings = single["step_dp"]["settings"]
            ref = {"dp": _jax_step(inputs, settings, "dp"),
                   "fsdp": _jax_step(inputs, settings, "fsdp"),
                   "predictor": _jax_predictor(inputs["predictor_ckpt"],
                                               inputs["predictor_images"]),
                   "evaluate": _jax_evaluate(inputs, settings["eval_temperature"])}
            logs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
        ranks = []
        for r in range(2):
            with open(work / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        yield SimpleNamespace(work=work, inputs=inputs, single=single, ranks=ranks, ref=ref,
                              logs=logs)
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The FSDP rule (no processes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,n,min_size", [
    ((3, 3, 64, 64), 8, fsdp.MIN_SHARD_SIZE), ((3, 3, 128, 64), 8, fsdp.MIN_SHARD_SIZE),
    ((64,), 8, fsdp.MIN_SHARD_SIZE), ((3, 3, 129, 67), 8, 0),
    ((3, 3, 128, 128), 1, fsdp.MIN_SHARD_SIZE), ((3, 3, 3, 16), 2, fsdp.MIN_SHARD_SIZE),
    ((32, 64), 2, fsdp.MIN_SHARD_SIZE)])
def test_fsdp_spec_equals_jax(shape, n, min_size):
    """JAX's own cases (`tests/test_parallel.py:54-70`) and two of yolov8n's
    leaves (the 432-element stem, a mapper kernel)."""
    assert fsdp.fsdp_spec(shape, n, min_size) == tuple(jfsdp.fsdp_spec(shape, n, min_size))


@pytest.mark.parametrize("n", [2, 8])
def test_shard_fraction_equals_jax(n, tmp_path):
    """The port Trainer's yolov8n train state (flax-layout variables, AdamW
    moments and counts, step) against JAX's TrainState of the same model,
    on shapes alone."""
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=NC, morph_downsample=DS)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, IMG, IMG, 3)), training=False),
                            jax.random.PRNGKey(0))
    tx = _jax_tx()
    state = jax.eval_shape(lambda v: TrainState.create(
        apply_fn=None, params=v["params"], tx=tx, batch_stats=v["batch_stats"],
        quant_stats=v["quant_stats"], buffers=v.get("buffers", {})), shapes)
    devices = np.asarray(jax.devices()[:n])
    jax_frac = jfsdp.shard_fraction(state, jax.sharding.Mesh(devices, ("data",)))

    batches = synthetic_batches(1, B, IMG, NC, max_boxes=MB, seed=0)
    port = Trainer(worker.trainer_config(tmp_path, "fsdp"), train_loader=batches,
                   val_loader=[], device="cpu")
    port_state = port._train_state_shapes()
    assert fsdp.shard_fraction(port_state, n) == pytest.approx(jax_frac, abs=1e-12)
    assert fsdp.shard_fraction(port_state["params"], n) == pytest.approx(
        jfsdp.shard_fraction(shapes["params"], jax.sharding.Mesh(devices, ("data",))),
        abs=1e-12)


def test_mesh_placements_and_one_rank_identity():
    """JAX's placement names, and every collective the identity without a
    group (one rank runs the one-device program)."""
    from torch.distributed.tensor import Replicate, Shard

    from mcaq_yolo_tpu_torch.parallel import mesh

    assert mesh.batch_sharding(None) == (Shard(0),)
    assert mesh.replicate_sharding(None) == (Replicate(),)
    x = torch.arange(6.0).reshape(3, 2)
    for f in (mesh.all_sum, mesh.all_mean, mesh.all_min, mesh.all_max, mesh.all_gather_cat):
        assert f(x, None) is x
    assert mesh.shard_batch(None, {"x": x}) == {"x": x}
    assert mesh.broadcast_object({"a": 1}, None) == {"a": 1}
    assert mesh.data_group(None) is None and mesh.mesh_size(None) == 1


def test_fsdp_shardings_map_the_jax_dim():
    """A conv kernel's chosen HWIO dim maps back to its OIHW dim, a Dense
    kernel's (in, out) dim to (out, in)."""
    model = MCAQYOLO(num_classes=NC, device="cpu")
    dims = fsdp.fsdp_shardings(model, SimpleNamespace(size=lambda: 2))
    conv = model.backbone.ConvBnSiLU_1.Conv_0.weight  # OIHW (32, 16, 3, 3), HWIO O=32
    assert dims[conv] == 0
    assert dims[model.backbone.ConvBnSiLU_0.Conv_0.weight] is None  # 432 elements
    dense = model.complexity_analyzer.complexity_mlp.Dense_1.weight  # (32, 64): in 64
    assert dims[dense] == 1
    assert dims[model.bit_mapper.MonotoneDense_1.theta] == 1  # (32, 64) as in JAX


# ---------------------------------------------------------------------------
# 2 ranks against 1 rank on the same global batch
# ---------------------------------------------------------------------------


def test_ranks_hold_their_rows(env):
    assert [r["shard_rows"] for r in env.ranks] == [[0, 1], [2, 3]]
    assert env.single["shard_rows"] == [0, 1, 2, 3]


@pytest.mark.parametrize("name", ["bn2d", "bn1d"])
def test_sync_batchnorm_equals_one_rank(env, name):
    one = env.single["batchnorm"][name]
    two = [r["batchnorm"][name] for r in env.ranks]
    _close(np.concatenate([t["y"] for t in two]), one["y"], 1e-5)
    _close(np.concatenate([t["x_grad"] for t in two]), one["x_grad"], 1e-5)
    for k in ("w_grad", "b_grad", "mean", "var"):
        for t in two:
            _close(t[k], one[k], 1e-5)


@pytest.mark.parametrize("mode", ["minmax", "percentile", "entropy", "mse"])
def test_quantizer_ranges_equal_one_rank(env, mode):
    one = env.single["quantizer"][mode]
    two = [r["quantizer"][mode] for r in env.ranks]
    keys = ["running_min", "running_max", "lo", "hi"] + (["histogram"] if mode == "entropy"
                                                         else [])
    for t in two:
        for k in keys:
            if mode == "mse":  # the error sums are per rank: the range within 1e-5
                _close(t[k], one[k], 1e-5)
            else:
                np.testing.assert_array_equal(t[k], one[k], err_msg=f"{mode}/{k}")
    for k in ("y", "y_train", "x_grad"):
        y = np.concatenate([t[k] for t in two])
        if mode == "mse":
            _close(y, one[k], 1e-5)
        else:
            np.testing.assert_array_equal(y, one[k], err_msg=f"{mode}/{k}")


def test_detection_loss_uses_the_global_target_sum(env):
    one = env.single["detection_loss"]
    two = [r["detection_loss"] for r in env.ranks]
    _close(np.mean([t["loss_vec"] for t in two], axis=0), one["loss_vec"], 1e-5)
    assert sum(t["num_fg"] for t in two) == one["num_fg"] > 0
    for s in range(3):
        _close(np.concatenate([t["map_grads"][s] for t in two]), one["map_grads"][s], 1e-5)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_train_step_equals_one_rank(env, mode):
    one = env.single["step_dp"]
    for r in env.ranks:
        two = r[f"step_{mode}"]
        for k, v in one["metrics"].items():
            assert two["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
        assert two["bit_hist"] == one["bit_hist"]
        _group_l2(two["grads"], one["grads"], 1e-4)
        for col in ("batch_stats", "quant_stats"):
            ref = dict(_leaves(one[col]))
            for name, val in _leaves(two[col]):
                if val.dtype.kind == "f":
                    _close(val, ref[name], 1e-4)
                else:
                    np.testing.assert_array_equal(val, ref[name], err_msg=name)


def test_fsdp_places_what_the_rule_shards(env):
    for r in env.ranks:
        placed = r["step_fsdp"]["placed"]
        assert any(dim is not None for _, dim in placed.values())
        for name, (is_dtensor, dim) in placed.items():
            assert is_dtensor == (dim is not None), name
        assert not any(d for d, _ in r["step_dp"]["placed"].values())


def test_predictor_data_parallel_equals_one_rank(env):
    """Both ranks return the whole list; it equals the one-rank Predictor
    on the same chunks (5 rounded up to 6; the ragged tail padded)."""
    ref = env.single["predictor"]
    for r in env.ranks:
        got = r["predictor"]
        assert len(got) == 11
        for a, b in zip(got, ref):
            for k in ("boxes", "conf", "cls", "bit_map"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["avg_bits"] == pytest.approx(b["avg_bits"], rel=1e-6)  # sum order


def test_evaluate_equals_one_rank(env):
    one = env.single["evaluate"]
    for r in env.ranks:
        got = r["evaluate"]
        assert got["map50"] == one["map50"] and got["map50_95"] == one["map50_95"]
        assert got["avg_bits"] == pytest.approx(one["avg_bits"], rel=1e-6)  # sum order
    assert one["map50"] > 0.2 and 2.0 < one["avg_bits"] < 8.0, one


def test_fsdp_resume_is_bit_identical(env):
    res = env.ranks[0]["resume"]
    assert res["bytes_equal"] and res["next_step_equal"] and res["next_params_equal"]
    assert env.ranks[1]["resume"] == res


def test_fsdp_checkpoint_loads_in_one_rank_and_jax(env):
    path = env.ranks[0]["resume"]["path"]
    payload = load_checkpoint(path)
    cfg = worker.trainer_config(env.work / "reload", "dp", env.inputs["teacher_path"])
    t = Trainer(cfg, train_loader=env.inputs["batches"][:1], val_loader=[], device="cpu")
    t.load_checkpoint(path)
    got = dict(to_jax_variables(t.model), opt_state=t.optimizer.state_tree(t.model),
               step=t.optimizer.step_count)
    for name, val in _leaves(payload):
        np.testing.assert_array_equal(dict(_leaves(got))[name], val, err_msg=name)

    # the JAX Trainer's load_checkpoint, on a zeroed TrainState of the model
    zeros = jax.tree_util.tree_map(np.zeros_like, _np(
        {k: payload[k] for k in ("params", "batch_stats", "quant_stats", "buffers")}))
    tx = _jax_tx()
    holder = SimpleNamespace(_place=lambda s: s, state=TrainState.create(
        apply_fn=None, params=zeros["params"], tx=tx, batch_stats=zeros["batch_stats"],
        quant_stats=zeros["quant_stats"], buffers=zeros["buffers"]))
    JaxTrainer.load_checkpoint(holder, path)
    st = holder.state
    restored = dict(_leaves(_np(serialization.to_state_dict({
        "params": st.params, "batch_stats": st.batch_stats, "quant_stats": st.quant_stats,
        "buffers": st.buffers, "opt_state": st.opt_state, "step": st.step}))))
    assert set(restored) == {name for name, _ in _leaves(payload)}
    for name, val in _leaves(payload):
        np.testing.assert_array_equal(restored[name], val, err_msg=name)
    assert int(st.step) == int(payload["step"]) > 0


# ---------------------------------------------------------------------------
# 2 port ranks against JAX's 2-device program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_train_step_equals_jax_sharded(env, mode):
    ref = env.ref[mode]
    got = env.ranks[0][f"step_{mode}"]
    for k in ("loss_total", "loss_det", "box_loss", "cls_loss", "dfl_loss", "loss_bit",
              "loss_smooth", "loss_kd", "loss_reg"):
        assert got["metrics"][k] == pytest.approx(float(ref["terms"][k]), rel=1e-3), k
    assert got["metrics"]["num_fg"] == float(ref["terms"]["num_fg"]) > 0
    assert got["metrics"]["avg_bits"] == pytest.approx(ref["avg_bits"], rel=1e-3)
    _group_l2(got["grads"], ref["grads"], 1e-2)
    for col, rel in (("batch_stats", 1e-2), ("quant_stats", 1e-4)):
        g = dict(_leaves(got[col]))
        for name, val in _leaves(ref["stats"][col]):
            if val.dtype.kind == "f":
                _close(g[name], val, rel)
            else:
                np.testing.assert_array_equal(g[name], val, err_msg=name)


def test_predictor_data_parallel_equals_jax(env):
    ref = env.ref["predictor"]
    got = env.ranks[0]["predictor"]
    assert len(got) == len(ref) == 11
    for a, b in zip(got, ref):
        assert len(a["cls"]) == len(b["detections"])
        for m, d in enumerate(b["detections"]):
            assert int(a["cls"][m]) == d["class_id"]
            np.testing.assert_allclose(a["conf"][m], d["confidence"], rtol=2e-5, atol=2e-6)


def test_evaluate_equals_jax(env):
    ref, got = env.ref["evaluate"], env.ranks[0]["evaluate"]
    assert got["map50"] == pytest.approx(ref["map50"], abs=1e-6)
    assert got["map50_95"] == pytest.approx(ref["map50_95"], abs=1e-6)
    assert got["avg_bits"] == pytest.approx(ref["avg_bits"], rel=1e-6)
