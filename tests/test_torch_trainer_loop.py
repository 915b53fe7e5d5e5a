"""The port's `Trainer` from a dataset on disk against the JAX `Trainer` on
the CPU: one module-scoped trainer of each package on one YOLO-format v3
synthetic dataset (16 train + 8 val images written at 96 px, trained at 96
px: the letterbox is the identity, so both read the same pixels), yolov8n,
nc 16, batch 4, KD off, `morphology.downsample: 2`, curriculum warm-up 1 and
transition 2 over 4 epochs (stages 1, 1, 2, 3).

Tolerances:
  * Eq.(8) complexity scores within 5e-4 absolute (measured 4.0e-4; scores
    0.34-0.38).  On uint8 images the gray level has many exact ties, and
    XLA's CPU program rounds x / 255 and the channel mean through fused
    multiply-adds, so a tied pair can differ by one ulp there; LBP and
    Canny's non-maximum suppression compare on ties, which moves a few
    tiles' metrics (ROADMAP C).  On float images away from ties the score
    is held at 1e-5 (`test_torch_data.py`);
  * the tau_t subset per epoch, and the first subset batch's files, equal;
  * `evaluate` at the same weights (made informative: bits spread over
    several widths, a few confident detections per image, the val split
    labelled with the port's detections): mAP@0.5 and mAP@[.5:.95] within
    1e-6, avg_bits within 1e-6 relative;
  * checkpoints: a port checkpoint restores into the JAX `Trainer`'s
    template (opt_state included) with every leaf bitwise equal; a JAX
    checkpoint with nonzero moments resumes in the port with `mu`, `nu`
    and both counts bitwise equal after the layout transforms.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from mcaq_yolo_tpu.data.dataset import make_synthetic_dataset_v3
from mcaq_yolo_tpu.train import Trainer as JaxTrainer
from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
from mcaq_yolo_tpu_torch.train import Trainer

IMG, NC, B, EPOCHS = 96, 16, 4, 4
REPO = Path(__file__).resolve().parents[1]


def _config(yaml_path, out):
    return {"epochs": EPOCHS, "batch_size": B, "learning_rate": 1e-3, "seed": 0,
            "output_dir": str(out),
            "model": {"name": "yolov8n", "num_classes": NC},
            "data": {"yaml_path": yaml_path, "img_size": IMG, "max_boxes": 16},
            "morphology": {"downsample": 2},
            "quantization": {"bit_mapping": "mlp", "monotone_param": "softplus"},
            "curriculum": {"warmup_epochs": 1, "transition_epochs": 2},
            "scheduler": {"warmup_epochs": 1}, "distillation": {"enabled": False},
            "training": {"amp": False, "map_interval": 1}}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    yaml_path = make_synthetic_dataset_v3(str(root / "ds"), n_images=16, img_size=IMG,
                                          n_val=8, seed=0)
    jax_trainer = JaxTrainer(_config(yaml_path, root / "jax"))
    port = Trainer(_config(yaml_path, root / "port"), device="cpu")
    return {"root": root, "yaml": yaml_path, "jax": jax_trainer, "port": port}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys(), sorted(set(fa) ^ set(fb))[:5]
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg="/".join(k))


def test_complexity_scores_match_jax(env):
    # measured max |diff| 4.0e-4 (uint8 gray-level ties split by XLA's FMA contraction)
    np.testing.assert_allclose(env["port"].complexity_scores, env["jax"].complexity_scores,
                               atol=5e-4, rtol=0)
    assert (env["root"] / "port" / "complexity_scores.npy.meta.json").exists()


def test_curriculum_subsets_per_epoch_match_jax(env):
    port, jt = env["port"], env["jax"]
    for epoch in range(EPOCHS):
        tau = port.curriculum.get_complexity_threshold(epoch)
        assert tau == jt.curriculum.get_complexity_threshold(epoch)
        pi, ji = port._curriculum_indices(tau), jt._curriculum_indices(tau)
        assert (pi is None) == (ji is None), epoch
        if pi is not None:
            np.testing.assert_array_equal(pi, ji)
    # epoch 0 filters: the subset loader (seed + epoch) batches the same files
    from mcaq_yolo_tpu.data.dataset import DataLoader as JaxLoader
    from mcaq_yolo_tpu_torch.data.dataset import DataLoader

    idx = port._curriculum_indices(port.curriculum.get_complexity_threshold(0))
    p_paths = [b["paths"] for b in DataLoader(port._scoring_dataset(), B, shuffle=True,
                                              indices=idx, seed=port.seed)]
    j_ds = type(jt.train_dataset)(jt.train_dataset.img_dir, IMG, 16, augment=False)
    j_paths = [b["paths"] for b in JaxLoader(j_ds, B, shuffle=True, indices=idx, seed=jt.seed)]
    assert p_paths == j_paths


def _spread(model, images):
    """Make a random model's outputs informative (as `chip_smoke.seeded_model`
    does at 640 px): the bit mapper's BatchNorm statistics from its own
    complexity maps and its last layer steepened, so tiles spread over bit
    widths; each class head's logits scaled to a spread of 6 with a bias
    that lets about one anchor per image and scale clear 0.5."""
    import torch.nn.functional as F

    from mcaq_yolo_tpu_torch.models.yolo import images_to_nchw

    x = torch.from_numpy(images)
    mapper = model.bit_mapper
    with torch.no_grad():
        feats = model.backbone(images_to_nchw(x, torch.float32))
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
        pyramid = model.neck(*[model.mcaq_transform(f, i, 1.0, True)[0]
                               for i, f in enumerate(feats)])
        for i, f in enumerate(pyramid):
            h = getattr(model.head, f"cls{i}_conv1")(getattr(model.head, f"cls{i}_conv0")(f))
            out = getattr(model.head, f"cls{i}_out")
            logits = F.conv2d(h, out.weight)
            scale = 6.0 / logits.std()
            out.weight.mul_(scale)
            best = (logits * scale).amax(dim=1).flatten(1)
            q = torch.quantile(best.flatten(), 1.0 - 1.0 / best.shape[1])
            out.bias.fill_(float(-q))


def test_evaluate_matches_jax_at_the_same_weights(env):
    """Both packages evaluate the same weights on a val split labelled with
    the port's own confident detections (score >= 0.25), so mAP is far from
    0 and moves with every detection either package finds."""
    from mcaq_yolo_tpu.data import dataset as jd
    from mcaq_yolo_tpu_torch.data import dataset as td

    port, jt = env["port"], env["jax"]
    images = np.concatenate([b["image"] for b in port.val_loader])
    _spread(port.model, images)
    epoch = EPOCHS - 1  # Stage 3
    temp = port.curriculum.get_effective_temperature(epoch)
    boxes, scores, classes, valid, _ = port.eval_step(torch.from_numpy(images), temp)
    val = env["root"] / "eval"
    for d in ("images", "labels"):
        (val / d / "val").mkdir(parents=True)
    n_labels = 0
    for i, path in enumerate(port.val_dataset.img_files):
        name = Path(path).name
        (val / "images" / "val" / name).write_bytes(Path(path).read_bytes())
        keep = valid[i] & (scores[i] >= 0.25)
        rows = [f"{int(c)} {(x1 + x2) / 2 / IMG:.9f} {(y1 + y2) / 2 / IMG:.9f} "
                f"{(x2 - x1) / IMG:.9f} {(y2 - y1) / IMG:.9f}"
                for (x1, y1, x2, y2), c in zip(boxes[i][keep].tolist(), classes[i][keep])]
        n_labels += len(rows)
        (val / "labels" / "val" / Path(name).with_suffix(".txt")).write_text("\n".join(rows))
    assert n_labels >= len(images)
    img_dir = str(val / "images" / "val")
    port.val_dataset = td.YOLODataset(img_dir, IMG, 16)
    port.val_loader = td.DataLoader(port.val_dataset, B, drop_last=False)
    jt.val_dataset = jd.YOLODataset(img_dir, IMG, 16)
    jt.val_loader = jd.DataLoader(jt.val_dataset, B, drop_last=False)

    jt.state = jt._place(jt.state.replace(**to_jax_variables(port.model)))
    for e in (0, epoch):  # Stage 1 (no quantization) and Stage 3
        p, j = port.evaluate(e), jt.evaluate(e)
        assert p["quantized"] == j["quantized"] == float(e > 0)
        assert p["map50"] == pytest.approx(j["map50"], abs=1e-6)
        assert p["map50_95"] == pytest.approx(j["map50_95"], abs=1e-6)
        assert p["avg_bits"] == pytest.approx(j["avg_bits"], rel=1e-6)
    assert p["map50"] > 0.2 and 2.0 < p["avg_bits"] < 8.0, p  # measured 0.4545, 4.72


def test_train_runs_the_stages_and_writes_the_files(env):
    port = env["port"]
    out = env["root"] / "port"
    before = port.model.complexity_analyzer.feature_weights.clone()
    result = port.train()
    stages = [h["stage"] for h in port.history]
    assert stages == [1, 1, 2, 3] and result["epochs"] == EPOCHS
    assert result["best_map50"] >= 0.0  # best.ckpt written in Stage 3
    for name in ("best.ckpt", "best.ckpt.json", "last.ckpt", "last.ckpt.json",
                 "history.json", "complexity_scores.npy"):
        assert (out / name).exists(), name
    for h in port.history:
        assert np.isfinite(h["loss_total"]) and np.isfinite(h["val_loss"])
        assert 0.0 <= h["map50"] <= 1.0 and 2.0 <= h["avg_bits"] <= 8.0
    assert port.history[0]["subset_size"] == 16 and port.history[2]["subset_size"] is None
    # the Stage-2 refit moved the Eq.(8) weights onto the simplex
    fw = port.model.complexity_analyzer.feature_weights
    assert not torch.equal(fw, before)
    assert bool((fw >= 0).all()) and float(fw.sum()) == pytest.approx(1.0, abs=1e-6)


def test_port_checkpoint_resumes_in_jax(env):
    """The reference's `load_checkpoint` restores into a template holding
    `opt_state`: a port checkpoint must carry it, in optax's layout."""
    port, jt = env["port"], env["jax"]
    path = port.save_checkpoint("resume.ckpt", 0)
    jt.load_checkpoint(str(path))
    state = jax.device_get(jt.state)
    assert int(state.step) == port.optimizer.step_count > 0
    _assert_trees_equal(serialization.to_state_dict(state.opt_state),
                        port.optimizer.state_tree(port.model))
    _assert_trees_equal({"params": state.params, "batch_stats": state.batch_stats,
                         "quant_stats": state.quant_stats, "buffers": state.buffers},
                        to_jax_variables(port.model))


def test_jax_checkpoint_resumes_in_the_port(env):
    jt = env["jax"]
    rng = np.random.default_rng(7)
    sd = serialization.to_state_dict(jax.device_get(jt.state.opt_state))
    adam, count = sd["1"]["0"], 5
    for key in ("mu", "nu"):
        adam[key] = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1, np.shape(a)).astype(np.float32) ** (2 if key == "nu"
                                                                          else 1), adam[key])
    adam["count"] = sd["1"]["2"]["count"] = np.asarray(count, np.int32)
    opt_state = serialization.from_state_dict(jt.state.opt_state, sd)
    jt.state = jt._place(jt.state.replace(opt_state=opt_state, step=count))
    jt.save_checkpoint("jax.ckpt", 0)

    fresh = Trainer(_config(env["yaml"], env["root"] / "fresh"), device="cpu")
    fresh.load_checkpoint(env["root"] / "jax" / "jax.ckpt")
    assert fresh.optimizer.step_count == count
    _assert_trees_equal(fresh.optimizer.state_tree(fresh.model), sd)
    state = jax.device_get(jt.state)
    _assert_trees_equal(to_jax_variables(fresh.model),
                        {"params": state.params, "batch_stats": state.batch_stats,
                         "quant_stats": state.quant_stats, "buffers": state.buffers})
    # one more step from the resumed state runs
    assert np.isfinite(fresh.train_epoch(EPOCHS - 1)["loss_total"])


def test_cli_trains_on_the_cpu(env, tmp_path):
    yaml = pytest.importorskip("yaml")
    config = _config(env["yaml"], tmp_path / "unused")
    config.update(epochs=1, curriculum={"enabled": False})
    cfg_path = tmp_path / "train.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    out = tmp_path / "cli"
    r = subprocess.run([sys.executable, "-m", "mcaq_yolo_tpu_torch.train", "--config",
                        str(cfg_path), "--device", "cpu", "--output-dir", str(out),
                        "--seed", "3"], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert '"epochs": 1' in r.stdout
    assert (out / "last.ckpt").exists() and (out / "history.json").exists()
    assert not (tmp_path / "unused").exists()


def test_cv2_score_backend_is_not_ported_yet(env, tmp_path):
    """The name predates the port of the cv2 backend; what it holds now:
    `curriculum.score_backend: cv2` scores the training images with the
    exact OpenCV metrics, equal bitwise to the JAX package's
    `score_image_cv2` on the same images, cached with backend "cv2"."""
    import json

    from mcaq_yolo_tpu.core.morphology_cv2 import score_image_cv2

    config = _config(env["yaml"], tmp_path)
    config["curriculum"] = dict(config["curriculum"], score_backend="cv2")
    port = Trainer(config, device="cpu")
    images = np.stack([port._scoring_dataset().get_item(i)["image"]
                       for i in range(len(port.train_dataset))])
    ref = score_image_cv2(images)  # float64; the scores cache holds float32
    np.testing.assert_array_equal(port.complexity_scores, ref.astype(np.float32))
    meta = json.loads((tmp_path / "complexity_scores.npy.meta.json").read_text())
    assert meta["backend"] == "cv2"
    np.testing.assert_array_equal(port._score_fn()(images[:4]), ref[:4])
