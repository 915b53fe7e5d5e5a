"""
Fully-sharded data parallelism over the same 1-D 'data' mesh (port of
`mcaq_yolo_tpu/parallel/fsdp.py`).

`training.parallel: fsdp` shards every large parameter, its AdamW moments
and the distillation teacher across the mesh instead of replicating them
on every card: a memory-capacity option (yolov8l/x with KD at large
batch), not a speed feature.  The JAX package commits shardings and lets
GSPMD insert the all-gathers and reduce-scatters; here FSDP2's
`fully_shard` does, with the sharded dimension given per parameter.

Sharding rule (leaf-wise, shape-only, JAX's): shard the largest dimension
divisible by the mesh size, the LAST such dimension on ties; leaves below
`min_size` elements replicate.  It is applied to each parameter's JAX
layout (a conv kernel is HWIO there and OIHW here, a dense kernel (in,
out) there and (out, in) here; `models/weights_io.param_leaves` knows the
map), so the port shards the same elements as the JAX package: the
chosen JAX dimension is mapped back to the torch tensor's.

FSDP2 has no replicated parameter inside a sharded group, so the
parameters the rule replicates are left out of it (`ignored_params`):
they stay plain tensors, broadcast from the first rank at placement, and
their gradients are averaged over the group with the data-parallel ones
(`train.Optimizer.step`).  One group per model (its root): the
parameters are gathered whole for the forward and backward and sharded
between steps, where the AdamW moments follow them.  The teacher is
gathered for its forward (`unsharded`) and freed after.

Buffers (BatchNorm statistics, the quantizers' EMA state) are not
parameters and stay replicated; they are identical on every rank because
they move by global statistics.  `shard_fraction` counts JAX's train
state (params, optimizer state, batch_stats, quant_stats, buffers, step),
as the JAX trainer's startup line does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch.nn as nn

from ..models.weights_io import param_leaves
from .mesh import DATA_AXIS, mesh_size, replicate

# Leaves with fewer elements than this replicate.  2048 keeps every conv
# kernel of the smallest variant (yolov8n stem: 3*3*3*16 = 432 < 2048 stays
# replicated; 3*3*16*32 = 4608 shards) while all scalar/1-D state replicates.
MIN_SHARD_SIZE = 2048


def fsdp_spec(shape, axis_size: int, min_size: int = MIN_SHARD_SIZE) -> Tuple:
    """JAX's PartitionSpec for one leaf as a tuple: DATA_AXIS at the
    largest divisible dim (the last on ties), None elsewhere; () for a
    replicated leaf (small, indivisible, or a mesh of one)."""
    shape = tuple(int(d) for d in shape)
    if axis_size <= 1 or int(np.prod(shape, dtype=np.int64)) < min_size:
        return ()
    best = -1
    for i, d in enumerate(shape):
        if d % axis_size == 0 and d >= axis_size:
            if best < 0 or d >= shape[best]:
                best = i
    if best < 0:
        return ()
    spec = [None] * len(shape)
    spec[best] = DATA_AXIS
    return tuple(spec)


def fsdp_shardings(module: nn.Module, mesh, min_size: int = MIN_SHARD_SIZE) -> Dict:
    """parameter -> the torch dim the rule shards (None: replicated), the
    rule applied to each parameter's JAX-layout shape."""
    n = mesh_size(mesh)
    out = {}
    for _, p, axes in param_leaves(module):
        jax_shape = p.shape if axes is None else tuple(p.shape[a] for a in axes)
        spec = fsdp_spec(jax_shape, n, min_size)
        out[p] = None if not spec else (
            spec.index(DATA_AXIS) if axes is None else axes[spec.index(DATA_AXIS)])
    return out


def fsdp_shard(module: nn.Module, mesh, min_size: int = MIN_SHARD_SIZE) -> nn.Module:
    """Shard `module`'s rule-sharded parameters over the mesh with FSDP2
    (`fully_shard` at the module, each parameter on its own dim) and
    broadcast the rest from the first rank; in place, returns the module.
    A mesh of one rank shards nothing."""
    if mesh_size(mesh) <= 1:
        return module
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dims = fsdp_shardings(module, mesh, min_size)
    replicated = {p for p, d in dims.items() if d is None}
    replicate(mesh, module)  # every parameter and buffer from the first rank
    for p, d in dims.items():
        if d is not None:  # FSDP2 shards row-major storage (no channels_last)
            p.data = p.data.contiguous()
    if len(replicated) < len(dims):
        fully_shard(module, mesh=mesh, shard_placement_fn=lambda p: Shard(dims[p]),
                    ignored_params=replicated)
    return module


def reshard(module: nn.Module) -> None:
    """Free the gathered parameters of a sharded module (FSDP2 keeps the
    root's gathered after a forward without gradient until the next
    backward); a no-op on any other module."""
    from torch.distributed.fsdp import FSDPModule

    if isinstance(module, FSDPModule):
        module.reshard()


@contextlib.contextmanager
def unsharded(module: Optional[nn.Module]):
    """The module's parameters gathered whole inside the block (a sharded
    teacher, whose methods other than forward read them), sharded again
    after; a no-op on any other module."""
    from torch.distributed.fsdp import FSDPModule

    if not isinstance(module, FSDPModule):
        yield
        return
    module.unshard()
    try:
        yield
    finally:
        module.reshard()


def shard_fraction(tree: Any, mesh, min_size: int = MIN_SHARD_SIZE) -> float:
    """Fraction of the elements of a flax-layout tree (nested dicts of
    arrays or shapes; e.g. a checkpoint payload: the JAX train state) that
    the rule shards, as the JAX trainer reports it."""
    n = mesh_size(mesh) if not isinstance(mesh, int) else mesh
    total = sharded = 0
    for leaf in _leaves(tree):
        shape = tuple(leaf) if isinstance(leaf, tuple) else tuple(np.shape(leaf))
        k = int(np.prod(shape, dtype=np.int64))
        total += k
        if fsdp_spec(shape, n, min_size) != ():
            sharded += k
    return sharded / max(total, 1)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
