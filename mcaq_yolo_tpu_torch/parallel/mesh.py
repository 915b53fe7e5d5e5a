"""
Data-parallel execution over a torch.distributed process group (port of
`mcaq_yolo_tpu/parallel/mesh.py`).

The JAX package runs one process over every local device: parameters are
replicated, the batch is split along the 'data' axis of a device mesh, and
`jit` makes every batch-wide reduction of the program global (GSPMD), so
its data-parallel step IS the one-device step on the global batch.  The
port runs one process per card (`torchrun --nproc-per-node N`); the group
of those processes is the mesh.  Every batch-wide reduction of the
training and serving programs goes through the functions below (BatchNorm
statistics, the quantizer's range, avg_bits, the detection loss's
normalizer, the gradient norm), so the N-rank program computes the
one-device program on the global batch.  Each is the identity without a
group (one rank): the one-rank program runs no collective.

A collective that fails raises (every call is synchronous); nothing here
falls back to local values.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

DATA_AXIS = "data"


def world_size() -> int:
    """Ranks in the default process group; 1 when none is initialized."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    """1-D `DeviceMesh` named 'data' over the first n ranks of the default
    group (all of them by default).  Every rank of the default group calls
    it; a rank outside the mesh gets a mesh whose coordinate is None
    (`in_mesh`)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group "
                           "(run under torchrun, or call init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks does not fit a group of {world}")
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(DATA_AXIS,))


def in_mesh(mesh) -> bool:
    return mesh is None or mesh.get_coordinate() is not None


def mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def data_group(mesh):
    """The process group of the mesh's 'data' axis, or None when the mesh
    has one rank (then no collective runs)."""
    if mesh is None or mesh.size() == 1:
        return None
    return mesh.get_group(DATA_AXIS)


def batch_sharding(mesh):
    """Leading-axis (batch) placement over the mesh."""
    from torch.distributed.tensor import Shard

    del mesh
    return (Shard(0),)


def replicate_sharding(mesh):
    from torch.distributed.tensor import Replicate

    del mesh
    return (Replicate(),)


def shard_batch(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of every array (tensor or numpy) in the batch dict:
    the leading axis is split into mesh-size contiguous slices, rank r
    taking slice r (JAX's `P('data')`).  Raises when it does not divide."""
    n = mesh_size(mesh)
    if n == 1:
        return batch
    r = mesh.get_local_rank(DATA_AXIS)
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) > 0:
            if v.shape[0] % n:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, which a mesh of {n} "
                                 "does not divide")
            m = v.shape[0] // n
            v = v[r * m:(r + 1) * m]
        out[k] = v
    return out


def replicate(mesh, module_or_tree):
    """Broadcast a module's parameters and buffers (or every tensor of a
    nested dict) from the mesh's first rank, in place; returns it."""
    group = data_group(mesh)
    if group is None:
        return module_or_tree
    if isinstance(module_or_tree, nn.Module):
        tensors = list(module_or_tree.parameters()) + list(module_or_tree.buffers())
    else:
        tensors = list(_tensor_leaves(module_or_tree))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=dist.get_global_rank(group, 0), group=group)
    return module_or_tree


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


# ---------------------------------------------------------------------------
# The global reductions of the data-parallel program
# ---------------------------------------------------------------------------


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllSum(torch.autograd.Function):
    """Sum over the group whose backward is the same sum of the output
    gradients: each rank's copy of a global quantity feeds that rank's
    loss, so the gradient w.r.t. one rank's input is the sum over ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = torch.clone(x, memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = torch.clone(grad, memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of x over the group (identity without one).

    With every rank's loss built so that its mean over the ranks is the
    global loss, and the parameter gradients averaged over the ranks
    (`Optimizer.step`, FSDP's reduce-scatter), the gradient that reaches
    the parameters is the global loss's."""
    return x if group is None else _AllSum.apply(x, group)


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable mean over the group of equal-sized slices' values."""
    return x if group is None else _AllSum.apply(x, group) / group_size(group)


def _reduced(x: torch.Tensor, op, group) -> torch.Tensor:
    y = torch.clone(x.detach(), memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def all_min(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum over the group (exact; no gradient)."""
    return x if group is None else _reduced(x, dist.ReduceOp.MIN, group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum over the group (exact; no gradient)."""
    return x if group is None else _reduced(x, dist.ReduceOp.MAX, group)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in rank order (equal shapes;
    no gradient): the global batch's rows from each rank's slice."""
    if group is None:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def broadcast_object(obj: Any, group) -> Any:
    """A picklable host object from the group's first rank to every rank."""
    if group is None:
        return obj
    box: List[Any] = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def is_first(group) -> bool:
    """True on the group's first rank (the rank that writes files)."""
    return group is None or dist.get_rank(group) == 0


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


@contextlib.contextmanager
def reduced_over(group, *objects):
    """Make the batch-wide reductions of `objects` (modules, searched
    through their submodules, or any object with a `data_group`
    attribute) run over `group` inside the block, restoring the previous
    groups after it."""
    holders = []
    for obj in objects:
        found = obj.modules() if isinstance(obj, nn.Module) else [obj]
        holders += [h for h in found if hasattr(h, "data_group")]
    before = [h.data_group for h in holders]
    for h in holders:
        h.data_group = group
    try:
        yield
    finally:
        for h, g in zip(holders, before):
            h.data_group = g
