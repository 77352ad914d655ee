"""A rank's rows of the global batch, for a distributed training step that
equals the one-process step on the union batch.

In the JAX package a multi-device step is the one-device function over one
global array, its random draws included. Under DDP each rank holds a block
of rows, so a draw with a batch dimension is made at the global batch's
shape from the generator every rank seeded alike, and the rank keeps its
rows: the generators stay in step, and the rank's numbers are the
one-process step's. A draw without a batch dimension is the same on every
rank. Draws over the valid (image, slot) pairs of the batch
(`models/criterion.py`) take the same rule over the pairs, whose global
list `gather_rows` assembles.

`train_step` opens `batch_rows(shard)` around each micro-batch; outside it
(one process, serving, evaluation) `draw` is the plain draw.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, NamedTuple, Optional

import torch
import torch.distributed as dist


class RowShard(NamedTuple):
    """Rows `start` to `start + count` of a batch of `total` rows. Under
    `batch_rows` every rank holds `count` rows and rank r's start at
    r * count."""

    total: int
    start: int
    count: int


_ACTIVE: List[RowShard] = []


@contextlib.contextmanager
def batch_rows(shard: Optional[RowShard]) -> Iterator[None]:
    """Draws inside are made as this rank's rows of the global batch
    (`shard` None: as in one process)."""
    if shard is None:
        yield
        return
    _ACTIVE.append(shard)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_rows() -> Optional[RowShard]:
    return _ACTIVE[-1] if _ACTIVE else None


def draw(make: Callable[[tuple], torch.Tensor], shape, axis: Optional[int],
         shard: Optional[RowShard] = None) -> torch.Tensor:
    """`make(shape)`, where `axis` of `shape` holds this rank's rows of
    `shard` (by default the open `batch_rows`), each row `shape[axis] /
    count` entries long: made at the global shape and cut to the rank's
    rows. `axis` None, or no shard: `make(shape)` itself."""
    shard = shard if shard is not None else current_rows()
    if shard is None or axis is None:
        return make(tuple(shape))
    shape = list(shape)
    # a shard of pairs may hold none on this rank: a pair is one entry
    per_row = shape[axis] // shard.count if shard.count else 1
    if per_row * shard.count != shape[axis]:
        raise ValueError(f"axis {axis} of {tuple(shape)} does not hold {shard.count} rows")
    wide = shape[:axis] + [shard.total * per_row] + shape[axis + 1:]
    return make(tuple(wide)).narrow(axis, shard.start * per_row, shape[axis]).contiguous()


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """`x`, this rank's rows of the open `batch_rows` along its first axis,
    -> the global batch's: (total * per_row, ...), every rank's block in
    place. By a sum of zero-padded blocks, which gloo carries for CUDA
    tensors too (it has no all-gather for them). `x` where no shard is open."""
    shard = current_rows()
    if shard is None:
        return x
    per_row = x.shape[0] // shard.count
    full = torch.zeros((shard.total * per_row, *x.shape[1:]), dtype=torch.int64
                       if x.dtype == torch.bool else x.dtype, device=x.device)
    full[shard.start * per_row:(shard.start + shard.count) * per_row] = x
    dist.all_reduce(full)
    return full.bool() if x.dtype == torch.bool else full
