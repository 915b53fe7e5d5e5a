"""Multi-device training and serving over a torch.distributed process group
(port of `mcaq_yolo_tpu/parallel/`): `mesh` (the 'data' mesh, batch
split, replication and the global reductions of the data-parallel
program) and `fsdp` (JAX's sharding rule through FSDP2)."""

from .._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "make_mesh": ".mesh",
    "batch_sharding": ".mesh",
    "replicate_sharding": ".mesh",
    "shard_batch": ".mesh",
    "replicate": ".mesh",
    "fsdp_spec": ".fsdp",
    "fsdp_shardings": ".fsdp",
    "fsdp_shard": ".fsdp",
    "shard_fraction": ".fsdp",
})
