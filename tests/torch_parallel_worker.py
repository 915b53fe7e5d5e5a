"""One rank of the port's multi-device programs on the CPU, for
`tests/test_torch_parallel.py` (which spawns two of it over gloo).  It
imports torch and the port only, never JAX or the test module.

    python tests/torch_parallel_worker.py WORKDIR RANK WORLD [gpu]

reads WORKDIR/inputs.pkl (batches, weights, the teacher and Predictor
checkpoints, made by the test from numpy seeds), joins the group through
a file store in WORKDIR, runs every rank-side case, and writes what the
test compares to WORKDIR/rank{RANK}.pkl: arrays and host values, from both
ranks, so the test can also hold the ranks to each other.  The same
functions run the one-rank program in the test's own process (no group).
With `gpu` the ranks share cuda:0 over gloo and run the GPU cases
(`tests/test_torch_gpu.py`; no inputs file).
"""

from __future__ import annotations

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from mcaq_yolo_tpu_torch.batch_norm import BatchNorm1d, BatchNorm2d  # noqa: E402
from mcaq_yolo_tpu_torch.core.quantization import SpatialAdaptiveQuantization  # noqa: E402
from mcaq_yolo_tpu_torch.inference import Predictor  # noqa: E402
from mcaq_yolo_tpu_torch.models.losses import DetectionLoss  # noqa: E402
from mcaq_yolo_tpu_torch.models.weights_io import (  # noqa: E402
    load_jax_variables,
    params_tree,
    to_jax_variables,
)
from mcaq_yolo_tpu_torch.parallel.fsdp import fsdp_shardings  # noqa: E402
from mcaq_yolo_tpu_torch.parallel.mesh import (  # noqa: E402
    data_group,
    group_size,
    make_mesh,
    reduced_over,
    shard_batch,
)
from mcaq_yolo_tpu_torch.train import Trainer  # noqa: E402
from mcaq_yolo_tpu_torch.utils.checkpoint import full_tensor  # noqa: E402

# the sizes of the port's single-device parity tests (tests/test_torch_train.py,
# test_torch_trainer_loop.py): at 96 px with the deployed downsample 2 the
# morphology's maps hold no Canny ties at these seeds (ROADMAP C)
IMG, NC, B, MB, DOWNSAMPLE = 96, 4, 4, 8, 2


EPOCH = 1  # the curriculum below: Stage 1 (no quantization) at 0, Stage 3 at 1


def trainer_config(out: Path, parallel: str, teacher_path=None, bit_mapping: str = "mlp") -> dict:
    """Two epochs, Stage 1 then Stage 3 (KD on when a teacher is given),
    float32, 96 px, morphology downsample 2; temperature 1, where the
    seeded mapper's bits spread over widths (above it they clip at 8)."""
    return {"epochs": 2, "batch_size": B, "learning_rate": 1e-3, "seed": 0,
            "output_dir": str(out),
            "model": {"name": "yolov8n", "num_classes": NC, "teacher_path": teacher_path},
            "morphology": {"downsample": DOWNSAMPLE},
            "quantization": {"bit_mapping": bit_mapping},
            "curriculum": {"enabled": False, "warmup_epochs": 0, "transition_epochs": 0,
                           "initial_temperature": 1.0},
            "scheduler": {"warmup_epochs": 1},
            "distillation": {"enabled": teacher_path is not None},
            "training": {"amp": False, "map_interval": 1, "parallel": parallel}}


def _np(t):
    return full_tensor(t).detach().cpu().numpy().copy()


def _rows(x, group):
    """This rank's rows of the global batch x (all of it without a group)."""
    if group is None:
        return x
    n, r = group_size(group), dist.get_rank(group)
    k = x.shape[0] // n
    return x[r * k:(r + 1) * k]


# ---------------------------------------------------------------------------
# Modules: BatchNorm, the quantizer's ranges, the detection loss
# ---------------------------------------------------------------------------


def batchnorm_case(group, device="cpu") -> dict:
    """BatchNorm2d and BatchNorm1d in training mode on this rank's rows of a
    seeded batch: outputs, the parameter gradients averaged over the group
    (as `Optimizer.step` averages them), the input gradient (x group size:
    each rank's loss carries the group's weight, see `parallel/mesh.py`)
    and the running statistics."""
    rng = np.random.default_rng(7)
    out = {}
    for name, bn, shape in (("bn2d", BatchNorm2d(6, momentum=0.1), (8, 6, 5, 5)),
                            ("bn1d", BatchNorm1d(6, momentum=0.1), (16, 6))):
        bn.to(device)
        x_all = torch.from_numpy(rng.normal(1.0, 2.0, shape).astype(np.float32)).to(device)
        w_all = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.normal(size=6).astype(np.float32)))
            bn.to(device)
        x = _rows(x_all, group).clone().requires_grad_(True)
        with reduced_over(group, bn):
            y = bn(x, training=True)
        (y * _rows(w_all, group)).sum().mul(group_size(group)).backward()
        grads = [bn.weight.grad, bn.bias.grad]
        if group is not None:
            for g in grads:
                dist.all_reduce(g, group=group)
                g.div_(group_size(group))
        out[name] = {"y": _np(y), "x_grad": _np(x.grad) / group_size(group),
                     "w_grad": _np(grads[0]), "b_grad": _np(grads[1]),
                     "mean": _np(bn.running_mean), "var": _np(bn.running_var)}
    return out


def quantizer_case(group) -> dict:
    """One EMA step in each calibration mode, then the eval range and the
    eval quantizer's output (plain version) on this rank's rows."""
    rng = np.random.default_rng(11)
    x_all = torch.from_numpy(rng.normal(0.0, 1.5, (4, 8, 8, 16)).astype(np.float32))
    bits_all = torch.from_numpy(rng.integers(2, 9, (4, 2, 2)).astype(np.float32))
    x, bits = _rows(x_all, group), _rows(bits_all, group)
    out = {}
    for mode in ("minmax", "percentile", "entropy", "mse"):
        q = SpatialAdaptiveQuantization(16, calibration_mode=mode, smooth_transitions=False,
                                        backend="torch")
        with reduced_over(group, q), torch.no_grad():
            q.ema_update(x)
            q.ema_update(x * 1.25 + 0.1)
            lo, hi = q.calibration_range(x)
            y = q(x, bits)
        # the training branch: one more EMA step, then the fractional
        # compose at the running range, and its gradient w.r.t. x
        xt = x.clone().requires_grad_(True)
        with reduced_over(group, q):
            yt = q(xt, bits - 0.3, training=True)
        (yt * x).sum().backward()
        out[mode] = {"running_min": _np(q.running_min), "running_max": _np(q.running_max),
                     "lo": _np(lo), "hi": _np(hi), "y": _np(y), "y_train": _np(yt),
                     "x_grad": _np(xt.grad)}
        if mode == "entropy":
            out[mode]["histogram"] = _np(q.histogram)
    return out


def detection_loss_case(batch: dict, group) -> dict:
    """DetectionLoss on seeded maps: each rank's terms (their mean over the
    ranks is the one-device loss, normalized by the global target-score
    sum) and the gradient w.r.t. the maps."""
    rng = np.random.default_rng(13)
    maps = [torch.from_numpy(rng.normal(0.0, 2.0, (B, s, s, 64 + NC)).astype(np.float32))
            for s in (IMG // 8, IMG // 16, IMG // 32)]
    maps = [_rows(m, group).clone().requires_grad_(True) for m in maps]
    gt = {k: torch.from_numpy(_rows(batch[k], group)) for k in ("gt_boxes", "gt_classes",
                                                                 "gt_mask")}
    loss_vec, items = DetectionLoss(NC)(maps, gt["gt_boxes"], gt["gt_classes"],
                                        gt["gt_mask"], group=group)
    loss_vec.sum().backward()
    return {"loss_vec": _np(loss_vec), "num_fg": int(items["num_fg"]),
            "map_grads": [_np(m.grad) / group_size(group) for m in maps]}


# ---------------------------------------------------------------------------
# The Trainer: one step, resume, evaluate
# ---------------------------------------------------------------------------


def trainer_step_case(inputs: dict, work: Path, parallel: str) -> dict:
    """A Trainer built on the test's student weights takes one step of the
    first global batch: its metrics, the gradient it computed (flax layout,
    the clip undone), the statistics after, and the parameters' placement.

    A step of Stage 1 (no quantization) with the constant bit mapper (4
    bits): otherwise one rounding difference decides the step.  A feature
    that sync-BN's sums (in another order than `F.batch_norm`'s) move by
    1e-5 can cross a quantization step (one of P5's 9,216 elements at these
    seeds), and with the MLP mapper the bits follow the complexity maps,
    whose Canny sits on ties at this size (a tile's complexity jumps, and
    the mapper's BatchNorm over a few tiles spreads it over the scale).
    Either moves this small random network's gradients by several percent.
    The quantizer's and the mapper's data-parallel parts are held alone
    (`quantizer_case`, `batchnorm_case`), in the eval forward
    (`predictor_case`, `evaluate_case`) and at Stage 3 (`resume_case`)."""
    cfg = trainer_config(work / f"step_{parallel}", parallel, inputs["teacher_path"],
                         bit_mapping="constant")
    t = Trainer(cfg, train_loader=[inputs["batches"][0]], val_loader=[], device="cpu")
    load_jax_variables(t.model, inputs["constant_student"])
    metrics = t.train_epoch(0)
    grads = params_tree(t.model, lambda p: p.grad)
    scale = max(float(metrics["grad_norm"]), 1.0)
    grads = _scaled(grads, scale)
    variables = to_jax_variables(t.model)
    rule = fsdp_shardings(t.model, t.mesh) if t.mesh is not None else {}
    placed = {".".join(path): (getattr(p, "placements", None) is not None, rule.get(p))
              for path, p in _named_leaves(t.model)}
    settings = {"weights": {k: v for k, v in t.curriculum.get_loss_weights(0).items()
                            if k != "detection"},
                "temperature": t.curriculum.get_effective_temperature(0),
                "target_bits": t.curriculum.get_target_bits(0),
                "eval_temperature": t.curriculum.get_effective_temperature(EPOCH)}
    return {"metrics": {k: v for k, v in metrics.items() if isinstance(v, (int, float))},
            "bit_hist": metrics["bit_hist"], "grads": grads, "settings": settings,
            "batch_stats": variables["batch_stats"], "quant_stats": variables["quant_stats"],
            "placed": placed}


def _named_leaves(model):
    from mcaq_yolo_tpu_torch.models.weights_io import param_leaves

    for path, p, _ in param_leaves(model):
        yield path, p


def _scaled(tree, s):
    return {k: _scaled(v, s) if isinstance(v, dict) else v * np.float32(s)
            for k, v in tree.items()}


def resume_case(inputs: dict, work: Path) -> dict:
    """'fsdp': a real step, save, load into a fresh Trainer, save again: the
    two files must be byte-equal and the loaded state equal the saved one."""
    cfg = trainer_config(work / "resume_a", "fsdp", inputs["teacher_path"])
    a = Trainer(cfg, train_loader=[inputs["batches"][1]], val_loader=[], device="cpu")
    load_jax_variables(a.model, inputs["student"])
    a.train_epoch(0)
    path_a = a.save_checkpoint("resume.ckpt", 0)
    b = Trainer(dict(cfg, output_dir=str(work / "resume_b")),
                train_loader=[inputs["batches"][1]], val_loader=[], device="cpu")
    b.load_checkpoint(path_a)
    path_b = b.save_checkpoint("resume.ckpt", 0)
    # the loaded Trainer goes on exactly as the saved one does
    ma, mb = a.train_epoch(1), b.train_epoch(1)
    return {"path": str(path_a), "bytes_equal": path_a.read_bytes() == path_b.read_bytes(),
            "next_step_equal": all(ma[k] == mb[k] for k in ma if isinstance(ma[k], float)),
            "next_params_equal": _trees_equal(to_jax_variables(a.model),
                                              to_jax_variables(b.model))}


def _trees_equal(x, y) -> bool:
    if isinstance(x, dict):
        return set(x) == set(y) and all(_trees_equal(x[k], y[k]) for k in x)
    return np.array_equal(x, y)


def evaluate_case(inputs: dict, work: Path) -> dict:
    """'dp' evaluate of the labelled val batches (one of them ragged) at
    Stage 3 (quantized) on the test's weights."""
    cfg = trainer_config(work / "eval", "dp")
    t = Trainer(cfg, train_loader=inputs["batches"][:1], val_loader=inputs["val_batches"],
                device="cpu")
    load_jax_variables(t.model, inputs["eval_weights"])
    return t.evaluate(EPOCH)


def predictor_case(inputs: dict, batch_size: int) -> list:
    """Predictor(data_parallel=True).predict_batch of 11 images (in a group
    of 2, chunks of 5 round up to 6): detections and maps."""
    pred = Predictor(inputs["predictor_ckpt"], img_size=IMG, data_parallel=True,
                     device="cpu")
    assert (pred.mesh is None) == (not dist.is_initialized())
    res = pred.predict_batch(list(inputs["predictor_images"]), batch_size=batch_size)
    return [{"boxes": np.array([d["bbox"] for d in r["detections"]], np.float32),
             "conf": np.array([d["confidence"] for d in r["detections"]], np.float32),
             "cls": np.array([d["class_id"] for d in r["detections"]], np.int64),
             "avg_bits": r["avg_bits"], "bit_map": r["bit_map"]} for r in res]


def kernel_range_case(group, device) -> dict:
    """The eval quantizer at yolov8n's P3 (640 px) in bfloat16 with the soft
    mask, on this rank's rows of a batch of 4: the batch range reduced over
    the group, the kernel's output and its plain version's."""
    from mcaq_yolo_tpu_torch.ops import spatial_quant as sq

    rng = np.random.default_rng(17)
    x_all = torch.from_numpy(rng.normal(0.0, 2.0, (4, 80, 80, 64)).astype(np.float32))
    bits_all = torch.from_numpy(rng.integers(2, 9, (4, 10, 10)).astype(np.float32))
    x = _rows(x_all, group).to(device, torch.bfloat16)
    bits = _rows(bits_all, group).to(device)
    q = SpatialAdaptiveQuantization(64)
    q.soft_mask.init_weights(torch.Generator().manual_seed(0))  # the same mask in every process
    q.to(device)
    out = {}
    # the soft mask's convolutions without cuDNN, whose algorithm follows
    # the batch (2 rows here, 4 in one rank): PyTorch's own is per image
    with reduced_over(group, q), torch.no_grad(), torch.backends.cudnn.flags(enabled=False):
        lo, hi = q.calibration_range(x)
        sq.spatial_quantize.launches = 0
        y_kernel = q(x, bits)
        out["launches"] = sq.spatial_quantize.launches
        q.backend = "torch"
        y_plain = q(x, bits)
    out.update(lo=_np(lo), hi=_np(hi), kernel=_np(y_kernel.float()), plain=_np(y_plain.float()))
    return out


def run_all(inputs: dict, work: Path, mesh) -> dict:
    """Every case on this rank (the mesh's data-parallel program; the ranks
    share `work`), or the one-rank program without a mesh."""
    group = data_group(mesh)
    return {
        "batchnorm": batchnorm_case(group),
        "quantizer": quantizer_case(group),
        "detection_loss": detection_loss_case(inputs["batches"][0], group),
        "step_dp": trainer_step_case(inputs, work, "dp"),
        "step_fsdp": trainer_step_case(inputs, work, "fsdp") if group is not None else None,
        "resume": resume_case(inputs, work) if group is not None else None,
        "evaluate": evaluate_case(inputs, work),
        # one rank: the chunks the group serves (5 rounded up to 6)
        "predictor": predictor_case(inputs, 5 if group is not None else 6),
        "shard_rows": shard_batch(mesh, {"x": np.arange(4)})["x"].tolist(),
    }


def run_gpu(mesh) -> dict:
    """The GPU cases on cuda:0 (the ranks share it)."""
    group = data_group(mesh)
    return {"kernel_range": kernel_range_case(group, torch.device("cuda", 0)),
            "batchnorm": batchnorm_case(group, torch.device("cuda", 0))}


def main(argv) -> int:
    work, rank, world = Path(argv[1]), int(argv[2]), int(argv[3])
    gpu = argv[4:] == ["gpu"]
    torch.set_num_threads(1)
    if gpu:
        torch.cuda.set_device(0)
    else:
        with open(work / "inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(device_type="cuda" if gpu else "cpu")
        out = run_gpu(mesh) if gpu else run_all(inputs, work / "ranks", mesh)
    finally:
        dist.destroy_process_group()
    with open(work / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main(sys.argv))
