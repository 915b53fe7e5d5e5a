"""Entry points (port of `__graft_entry__.py`).

    entry(device=None) -> (fn, (model, images))
        the deployed MCAQ-YOLOv8n forward (nc 80, MLP bit mapper, float32,
        seeded weights) on one card: fn(model, images) -> (raw_maps,
        avg_bits) at temperature 1.0, quantized, eval mode.  On CUDA it runs
        both hand-written kernels: 3 launches of `mcaq::spatial_quantize`
        and 3 of `mcaq::phi_tiles` a call.
    dryrun_multichip(n_devices, device=None, state=None) -> dict
        three programs over an n-rank 'data' mesh on tiny shapes (64 px,
        nc 4, grid 4, one image a rank), as the JAX dryrun runs them: the
        full MCAQ train step under DP (KD teacher, quantized forward,
        AdamW, clip 1.0), the DP serving program (forward + decode + NMS)
        and the same train step under FSDP; prints one line for each.

    python -m mcaq_yolo_tpu_torch.entry [n]     # dryrun_multichip(n), n = 8 by default

Ranks: inside an initialized process group (`torchrun --nproc-per-node n
-m mcaq_yolo_tpu_torch.entry n`) the dryrun runs in place, each rank on its
own card (cuda:{LOCAL_RANK}, NCCL).  Otherwise it spawns n ranks that join
through a file store in a temporary directory: one card each over NCCL
when there are n cards, else sharing the cards over gloo (NCCL refuses two
ranks on one GPU), which it says on a line of its own; with device="cpu"
they are gloo CPU ranks.  Without CUDA and without device="cpu" both entry
points raise: nothing here drops to the CPU on its own.

The three programs are functions of a state (`init_state`: the student's
and teacher's flax-layout variables and the AdamW state in optax's
layout), so a caller can run them on weights made elsewhere, e.g. the JAX
package's, which `models.weights_io.load_jax_variables` reads.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .core import morphology_lanes
from .core.bit_allocation import enforce_monotonic_params
from .device import DeviceLike, resolve_device
from .models.losses import MCAQYOLOLoss
from .models.mcaq_yolo import MCAQYOLO
from .models.weights_io import load_jax_variables, param_leaves, to_jax_variables
from .models.yolo import YOLOv8, decode_and_nms
from .ops import spatial_quant
from .parallel import fsdp
from .parallel.mesh import (
    all_gather_cat,
    data_group,
    make_mesh,
    reduced_over,
    replicate,
    shard_batch,
)
from .train import Optimizer, _process_group, make_train_step

# ---------------------------------------------------------------------------
# entry(): the deployed forward on one card
# ---------------------------------------------------------------------------

ENTRY_BATCH, ENTRY_IMG, ENTRY_CLASSES = 4, 640, 80


def entry(device: DeviceLike = None):
    """(fn, (model, images)): the JAX entry's yolov8n (nc 80, MLP mapper,
    float32 parameters) with the port's seeded init (a CPU torch.Generator
    seeded 0), in eval mode, and zero images of JAX's (4, 640, 640, 3) in
    the port's layout: (4, 3, 640, 640) float32 channels_last, whose memory
    is that NHWC array."""
    device = resolve_device(device)
    model = MCAQYOLO("yolov8n", num_classes=ENTRY_CLASSES, bit_mapping="mlp",
                     dtype=torch.float32, device=device, seed=0)
    model.eval()
    images = torch.zeros((ENTRY_BATCH, 3, ENTRY_IMG, ENTRY_IMG), dtype=torch.float32,
                         device=device).contiguous(memory_format=torch.channels_last)
    return fn, (model, images)


def fn(model: MCAQYOLO, images: torch.Tensor):
    """(raw_maps, avg_bits) of the quantized eval forward at temperature 1.0;
    `images` (B, 3, H, W) channels_last (their NHWC view is the model's
    input, no copy)."""
    with torch.no_grad():
        raw_maps, aux = model(images.permute(0, 2, 3, 1), temperature=1.0, quantize=True,
                              training=False)
    return raw_maps, aux["avg_bits"]


# ---------------------------------------------------------------------------
# dryrun_multichip(): the three programs over an n-rank mesh
# ---------------------------------------------------------------------------

IMG, NC, GRID, BOX_SLOTS = 64, 4, 4, 8
MAX_DET, PRE_TOPK = 32, 64
# temperature, target_bits, lw_bit, lw_smooth, lw_kd, lw_reg (__graft_entry__.py:148-152)
STEP_ARGS = (1.0, 4.0, 0.01, 0.1, 0.5, 1e-4)
# optax.adamw(1e-3) as the JAX dryrun builds it: a constant rate, weight
# decay 1e-4 on every parameter (no mask)
LR, WEIGHT_DECAY = 1e-3, 1e-4


def dryrun_batch(n: int) -> Dict[str, np.ndarray]:
    """The JAX dryrun's global batch of n images (`np.random.default_rng(0)`):
    random float images, one box [4, 4, 40, 40] of class 0 in M = 8 slots."""
    rng = np.random.default_rng(0)
    return {"image": rng.random((n, IMG, IMG, 3)).astype(np.float32),
            "gt_boxes": np.tile(np.array([[4, 4, 40, 40]], np.float32), (n, BOX_SLOTS, 1)),
            "gt_classes": np.zeros((n, BOX_SLOTS), np.int32),
            "gt_mask": np.tile(np.array([True] + [False] * (BOX_SLOTS - 1)), (n, 1))}


def _student(device) -> MCAQYOLO:
    return MCAQYOLO("yolov8n", num_classes=NC, bit_mapping="mlp", grid_size=GRID,
                    device=device, seed=0)


def _teacher(device) -> YOLOv8:
    return YOLOv8("yolov8n", NC, device=device, seed=1)


def init_state(device: DeviceLike = None) -> Dict:
    """The dryrun's seeded starting state: the student (its bit mapper
    projected by Eq.18, as the JAX dryrun does before its first step) and
    the teacher as flax-layout variables, and no optimizer state yet."""
    device = resolve_device(device)
    student = _student(device)
    enforce_monotonic_params(student.bit_mapper)
    return {"student": to_jax_variables(student), "teacher": to_jax_variables(_teacher(device)),
            "opt_state": None, "step": 0}


def _build(state: Dict, device, mesh, mode: str):
    """The student, teacher and optimizer of `state`, placed on the mesh:
    'dp' replicates them from the first rank, 'fsdp' shards them."""
    student = load_jax_variables(_student(device), state["student"])
    teacher = load_jax_variables(_teacher(device), state["teacher"])
    for module in (student, teacher):
        if mode == "fsdp":
            fsdp.fsdp_shard(module, mesh)
        else:
            replicate(mesh, module)
    optimizer = Optimizer(student, lambda step: LR, weight_decay=WEIGHT_DECAY,
                          decay_bit_mapper=True, group=data_group(mesh))
    if state["opt_state"] is not None:
        optimizer.load_state_tree(student, state["opt_state"])
    return student, teacher, optimizer


def _on_device(batch: Dict[str, np.ndarray], mesh, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in shard_batch(mesh, batch).items()}


def _train_step(state: Dict, batch: Dict[str, np.ndarray], mesh, device, mode: str):
    student, teacher, optimizer = _build(state, device, mesh, mode)
    loss_obj = MCAQYOLOLoss(NC, STEP_ARGS[1])
    step = make_train_step(student, loss_obj, teacher)
    with reduced_over(data_group(mesh), student, loss_obj):
        metrics = step(optimizer, _on_device(batch, mesh, device), *STEP_ARGS,
                       quantize=True, use_kd=True)
    metrics = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
    new_state = {"student": to_jax_variables(student), "teacher": state["teacher"],
                 "opt_state": optimizer.state_tree(student), "step": state["step"] + 1}
    return metrics, new_state, student


def dp_train_step(state: Dict, batch: Dict[str, np.ndarray], mesh,
                  device: DeviceLike = None) -> Tuple[Dict, Dict]:
    """Program 1: one MCAQ train step with the batch split over the mesh and
    the weights replicated -> (the global batch's metrics, the new state)."""
    metrics, new_state, _ = _train_step(state, batch, mesh, resolve_device(device), "dp")
    return metrics, new_state


def dp_serving(state: Dict, images: np.ndarray, mesh, device: DeviceLike = None):
    """Program 2: the quantized eval forward + decode + NMS (max_det 32, pool
    64) on this rank's rows, the quantizer's batch range reduced over the
    mesh -> (boxes, scores, classes, valid) of the whole batch, gathered
    from every rank, and the global avg_bits."""
    device = resolve_device(device)
    student = replicate(mesh, load_jax_variables(_student(device), state["student"]))
    group = data_group(mesh)
    x = _on_device({"image": images}, mesh, device)["image"]
    with reduced_over(group, student), torch.no_grad():
        raw, aux = student(x, temperature=1.0, quantize=True, training=False)
        out = decode_and_nms(raw, NC, max_det=MAX_DET, pre_topk=PRE_TOPK)
    return tuple(all_gather_cat(o, group) for o in out) + (aux["avg_bits"],)


def train_state_tree(state: Dict) -> Dict:
    """The JAX dryrun's TrainState as a flax-layout tree (step, params,
    opt_state, batch_stats, quant_stats, buffers): what `shard_fraction`
    counts."""
    return dict(state["student"], opt_state=state["opt_state"],
                step=np.asarray(state["step"], np.int32))


def fsdp_train_step(state: Dict, batch: Dict[str, np.ndarray], mesh,
                    device: DeviceLike = None) -> Tuple[Dict, Dict, float, bool]:
    """Program 3: the train step with the student's and teacher's large
    parameters and AdamW moments sharded over the mesh (`parallel/fsdp.py`)
    -> (metrics, the new state, the fraction of the train state's elements
    the rule shards, whether every rank holds the same replicated leaves
    after the step)."""
    device = resolve_device(device)
    frac = fsdp.shard_fraction(train_state_tree(state), mesh)
    metrics, new_state, student = _train_step(state, batch, mesh, device, "fsdp")
    # the leaves every rank holds whole: the parameters the rule replicates
    # and the buffers (BatchNorm and quantizer statistics)
    dims = fsdp.fsdp_shardings(student, mesh)
    whole = [p for _, p, _ in param_leaves(student) if dims[p] is None]
    whole += list(student.buffers())
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in whole])
    rows = all_gather_cat(flat[None], data_group(mesh))
    same = bool((rows == rows[0]).all())
    return metrics, new_state, frac, same


def _launch_counts() -> Dict[str, int]:
    return {"spatial_quant": spatial_quant.spatial_quantize.launches,
            "phi_tiles": morphology_lanes.phi_tiles.launches}


def _zero_launches() -> None:
    spatial_quant.spatial_quantize.launches = 0
    morphology_lanes.phi_tiles.launches = 0


def run_programs(n_devices: int, device, state: Optional[Dict] = None) -> Dict:
    """The three programs on this rank of an initialized group, over a mesh of
    its first n ranks, each with the kernels' launches counted from 0 just
    before it; the next program starts from the state the last one left."""
    device = resolve_device(device)
    mesh = make_mesh(n_devices, device.type)
    state = init_state(device) if state is None else state
    batch = dryrun_batch(n_devices)
    out: Dict = {"n_devices": n_devices, "launches": {}}

    def counted(name, program, *args):
        _zero_launches()
        result = program(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["launches"][name] = _launch_counts()
        return result

    metrics, out["state_after_dp"] = counted("dp", dp_train_step, state, batch, mesh, device)
    out["dp"] = {"loss": metrics["loss_total"], "avg_bits": metrics["avg_bits"]}
    _check_finite("DP step loss", out["dp"]["loss"])

    boxes, scores, classes, valid, avg_bits = counted(
        "serving", dp_serving, out["state_after_dp"], batch["image"], mesh, device)
    out["serving"] = {"boxes_shape": tuple(boxes.shape), "avg_bits": float(avg_bits),
                      "valid": int(valid.sum())}
    if out["serving"]["boxes_shape"] != (n_devices, MAX_DET, 4):
        raise RuntimeError(f"DP serving boxes {out['serving']['boxes_shape']}, expected "
                           f"{(n_devices, MAX_DET, 4)}")
    _check_finite("DP serving avg_bits", out["serving"]["avg_bits"])

    metrics, _, frac, same = counted(
        "fsdp", fsdp_train_step, out["state_after_dp"], batch, mesh, device)
    out["fsdp"] = {"loss": metrics["loss_total"], "fraction": frac,
                   "replicated_equal": same}
    _check_finite("FSDP step loss", out["fsdp"]["loss"])
    if not frac > 0.5:
        raise RuntimeError(f"FSDP rule sharded only {frac:.0%} of state elements")
    if not same:
        raise RuntimeError("after the FSDP step the ranks hold different replicated leaves")
    return out


def _check_finite(what: str, x: float) -> None:
    if not np.isfinite(x):
        raise RuntimeError(f"non-finite {what}: {x}")


def report(result: Dict) -> None:
    """The JAX dryrun's three lines."""
    n = result["n_devices"]
    print(f"[dryrun_multichip] {n}-device DP step OK: loss={result['dp']['loss']:.4f} "
          f"avg_bits={result['dp']['avg_bits']:.2f}")
    print(f"[dryrun_multichip] {n}-device DP serving (decode+NMS) OK: "
          f"avg_bits={result['serving']['avg_bits']:.2f}")
    print(f"[dryrun_multichip] {n}-device FSDP step OK: loss={result['fsdp']['loss']:.4f} "
          f"({result['fsdp']['fraction']:.0%} of state elements sharded)", flush=True)


def _rank_main(work: str, rank: int, n: int, device: str, backend: str, state,
               threads: int, tf32: Tuple[bool, bool]) -> None:
    """One spawned rank, with the caller's intra-op threads and TF32 flags:
    join the group through the file store in `work`, run the programs,
    write rank{r}.pkl."""
    import datetime

    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{work}/store", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=600))
    try:
        out = run_programs(n, dev, state)
    finally:
        dist.destroy_process_group()
    if rank:  # the states are the same on every rank: the first one returns them
        del out["state_after_dp"]
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


RANK_TIMEOUT_S = 1200.0  # a spawned rank still running after this is stopped


def dryrun_multichip(n_devices: int = 8, device: DeviceLike = None,
                     state: Optional[Dict] = None) -> Dict:
    """Run the three programs over n ranks and print the three lines.
    Returns the first rank's results: each program's numbers, the state
    after the DP step, and `launches`; spawned ranks also give
    `launches_per_rank`.  `state` (default `init_state`) is the starting
    state, e.g. JAX's weights in flax layout."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                             f"{dist.get_world_size()} ranks: run n ranks for n devices")
        result = run_programs(n_devices, resolve_device(device), state)
        if dist.get_rank() == 0:
            report(result)
        return result

    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if n_devices <= cards else "gloo"
        devices = [f"cuda:{r if backend == 'nccl' else r % cards}" for r in range(n_devices)]
        if backend == "gloo":
            print(f"[dryrun_multichip] {n_devices} ranks share {cards} card(s) over gloo "
                  "(NCCL refuses two ranks on one GPU)", flush=True)
    else:
        backend, devices = "gloo", ["cpu"] * n_devices
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mcaq_dryrun_") as work:
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        procs = [ctx.Process(target=_rank_main, args=(work, r, n_devices, devices[r], backend,
                                                       state, torch.get_num_threads(), tf32))
                 for r in range(n_devices)]
        try:
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"dryrun ranks exited with {codes}")
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    result = ranks[0]
    result["launches_per_rank"] = [r["launches"] for r in ranks]
    report(result)
    return result


def main(argv=None) -> int:
    """`python -m mcaq_yolo_tpu_torch.entry [n]`; under torchrun each rank
    joins the group it describes and the dryrun runs in place."""
    argv = sys.argv[1:] if argv is None else argv
    device = resolve_device(None)
    with _process_group(device):
        dryrun_multichip(int(argv[0]) if argv else 8, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
