"""The data mesh over ``torch.distributed`` (port of
``reid_gan_tpu/parallel``): one process a card, replicated state, sharded
batches, explicit collectives."""

from .mesh import (
    Mesh,
    all_gather_rows,
    assemble_rows,
    all_reduce_grads,
    all_reduce_mean,
    all_reduce_means,
    all_reduce_sum,
    broadcast_object,
    destroy_mesh,
    get_mesh,
    is_main,
    launch,
    local_device_count,
    mesh_device,
    pad_to_multiple,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "all_gather_rows",
    "assemble_rows",
    "all_reduce_grads",
    "all_reduce_mean",
    "all_reduce_means",
    "all_reduce_sum",
    "broadcast_object",
    "destroy_mesh",
    "get_mesh",
    "is_main",
    "launch",
    "local_device_count",
    "mesh_device",
    "pad_to_multiple",
    "replicate",
    "shard_batch",
]
