"""The data-parallel layout a config asks for (`mp_former_tpu/parallel/mesh.py:
create_mesh`).

The JAX package lays one `data` mesh axis over its devices and lets GSPMD
shard the batch; the port runs one process a card under DDP, so the mesh is
the process group and `TPU.MESH_SHAPE` / `TPU.MESH_AXES` only say how many
ranks share the batch. The JAX file's layout helpers (`maybe_constrain`,
`constrain_replicated`, `shard_batch`, `replicate`) have no role under DDP:
each card holds whole images and the whole model.
"""

from __future__ import annotations


def data_parallel_size(cfg, world_size: int) -> int:
    """The number of ranks that split each batch: `TPU.MESH_SHAPE` over the
    single axis `data` of `TPU.MESH_AXES`, where `[-1]` means every rank.
    Raises on any other axis, and on a size that is not the world size (the
    JAX `create_mesh` takes the first devices of a larger set; here every
    rank trains)."""
    shape, axes = list(cfg.TPU.MESH_SHAPE), list(cfg.TPU.MESH_AXES)
    if axes != ["data"] or len(shape) != 1:
        raise ValueError(f"TPU.MESH_AXES {axes} with TPU.MESH_SHAPE {shape}: the port splits "
                         "the batch over one axis, ['data'], and nothing else")
    size = world_size if shape[0] == -1 else int(shape[0])
    if size != world_size:
        raise ValueError(f"TPU.MESH_SHAPE {shape} asks for {size} data-parallel ranks, but "
                         f"{world_size} processes run: set it to [-1] or [{world_size}]")
    return size
