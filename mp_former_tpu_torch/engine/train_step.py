"""One training step (`mp_former_tpu/engine/train_step.py:37-196`): global
num_masks, forward with DN queries, criterion, weighted total, backward, clip,
optimizer step. `TPU.GRAD_ACCUM_STEPS` > 1 splits the batch into micro-batches
that the host runs one after the other, each forward and backward adding into
`.grad` and freeing its graph before the next (activation memory scales with
B/accum), then clips and updates once. `SPLIT_STEP`, `HOST_ACCUM` and `DONATE`
are not ported: they lay out the JAX package's step around its TPU runtime
client (PERFORMANCE.md round 4). Nor is its two-phase host matcher: the
matcher here is on the host already, per micro-batch.

Each stage of the step (forward, matcher costs, the host's assignment solve,
losses, backward, optimizer) runs inside `stage(name)`: by default a
`record_function("stage::<name>")` range, which a `torch.profiler` trace of
the step shows and which costs nothing when no profiler records.

Under DDP (`model` wrapped by `Trainer` where a process group runs) a step of
W ranks, each with its block of rows of the global batch, is the
one-process step on the whole batch, as the JAX package's multi-device step
is its one-device function (`mp_former_tpu/engine/trainer.py:88-96`), up to
the order in which floats are summed. DDP averages the ranks' gradients, so
each rank's losses carry W times its share: the mask and dice terms divide
by the global num_masks over W (reference criterion.py:235-237), the class
terms by the global weight sum of their weighted mean over W (each rank's
own weighted mean would differ where the ranks hold different numbers of
instances). The random draws are the global batch's (`parallel/rows.py`),
the slot axis is padded to the largest rank's, and the returned losses are
averaged over the ranks, d2's `reduce_dict`. The micro-batches before the
last run under `no_sync`: one gradient all-reduce a step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..parallel.dist import all_reduce_sum, get_rank, get_world_size
from ..parallel.rows import RowShard, batch_rows, gather_rows
from ..structures import Batch


def compute_dn_groups(scalar: int, valid: torch.Tensor,
                      bucket: int = 1) -> Optional[Tuple[int, int]]:
    """(group count, batch max instance count) for the NUM_DN >= 100
    convention, where `scalar` is a budget of DN queries that the reference
    divides by the batch's largest instance count
    (mask2former_transformer_decoder.py:973-974); None below 100. `bucket` > 1
    (TPU.DN_GROUP_BUCKET) rounds that count up to a multiple of `bucket`,
    capped at the slots there are, before the division, as the JAX package
    does to bound its number of compiled programs."""
    if scalar < 100:
        return None
    m = max(int(valid.sum(-1).max()), 1)
    if bucket > 1:
        m = min(-(-m // bucket) * bucket, valid.shape[-1])
    return max(1, scalar // m), m


def micro_batches(batch: Batch, accum: int) -> Iterator[Batch]:
    """The JAX package's strided split (`train_step.py:148-154`): micro-batch
    k holds rows k, k + accum, ...; the whole batch when `accum` is 1. The
    targets keep their type (`Targets` or `VideoTargets`)."""
    b = batch.images.shape[0]
    if b % accum:
        raise ValueError(f"a batch of {b} images does not split into "
                         f"TPU.GRAD_ACCUM_STEPS={accum} micro-batches")
    if accum == 1:
        yield batch
        return

    def part(x: torch.Tensor, k: int) -> torch.Tensor:
        return x.reshape(b // accum, accum, *x.shape[1:])[:, k].contiguous()

    for k in range(accum):
        targets = batch.targets
        yield Batch(part(batch.images, k), type(targets)(*(part(t, k) for t in targets)))


def pad_slots(batch: Batch, n: int) -> Batch:
    """The targets' slot axis padded with invalid slots to `n`."""
    targets = batch.targets
    extra = n - targets.num_instances
    if extra <= 0:
        return batch
    padded = (torch.cat([t, t.new_zeros((t.shape[0], extra, *t.shape[2:]))], 1) for t in targets)
    return Batch(batch.images, type(targets)(*padded))


def _global_slots(batch: Batch) -> Batch:
    """`batch` with as many slots as the largest rank's (a clip loader cuts
    the slot axis after its batch's last valid slot, `video/ytvis.py:
    collate_clips`, so a rank's block can hold fewer than the global batch)."""
    n = torch.tensor([batch.targets.num_instances], device=batch.images.device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    return pad_slots(batch, int(n))


def _stage_range(name: str) -> ContextManager:
    return record_function(f"stage::{name}")


def train_step(model, criterion, optimizer, scheduler, batch: Batch,
               generator: Optional[torch.Generator] = None,
               clip_gradients: Optional[Callable] = None,
               dn_group_bucket: int = 1, accum: int = 1,
               stage: Optional[Callable[[str], ContextManager]] = None
               ) -> Dict[str, torch.Tensor]:
    """Forward, losses, backward, clip, update; returns the (detached) loss
    dict with the reference's keys and `total_loss`. `generator` feeds the DN
    noise, the matcher's points and the loss's point sampling, in that order,
    micro-batch by micro-batch.

    With `accum` > 1 (`train_step.py:74-85`): every micro-batch's criterion
    normalises by the whole batch's num_masks, so the mask and dice terms sum
    to the full batch's; the `loss_ce*` terms are means over their micro-batch
    and are divided by `accum` before the weighted total; the returned dict
    sums the micro terms, the `loss_ce*` sums divided by `accum`. The DN
    groups come from the whole batch. `stage(name)` is entered around each
    stage (each micro-batch's); by default a `record_function` range."""
    stage = stage or _stage_range
    world, rank = get_world_size(), get_rank()
    b = batch.images.shape[0]
    if world > 1:
        batch = _global_slots(batch)
    with batch_rows(RowShard(world * b, rank * b, b) if world > 1 else None):
        valid = gather_rows(batch.targets.valid)  # the global batch's
    # the valid instances of the global batch (reference all_reduce, criterion.py:235-237),
    # over W for DDP's mean
    num_masks = valid.sum().float().clamp(min=1.0) / world
    net = getattr(model, "module", model)
    dn_groups = compute_dn_groups(net.scalar, valid, dn_group_bucket)
    optimizer.zero_grad(set_to_none=True)
    total, sums = None, {}
    micro_rows = b // accum
    for m, micro in enumerate(micro_batches(batch, accum)):
        # this rank's rows of the global batch's micro-batch m (rows m, m + accum, ...)
        shard = RowShard(world * micro_rows, rank * micro_rows, micro_rows) if world > 1 else None
        # DDP: one gradient all-reduce a step, after the last micro-batch
        defer = hasattr(model, "no_sync") and m < accum - 1
        sync = model.no_sync() if defer else contextlib.nullcontext()
        with batch_rows(shard), sync:
            with stage("forward"):
                outputs = model(micro.images, micro.targets, dn_groups=dn_groups,
                                generator=generator)
            with stage("matcher_costs"):
                costs = criterion.layer_costs(outputs, micro.targets, generator)
            with stage("matcher_host"):
                assignments = criterion.assign(costs)
            with stage("losses"):
                class_norm = None
                if world > 1:
                    class_norm = all_reduce_sum(criterion.class_weight_sums(
                        outputs, micro.targets, assignments)) / world
                losses = criterion(outputs, micro.targets, generator, num_masks=num_masks,
                                   assignments=assignments, class_norm=class_norm)
                del outputs
                if accum > 1:
                    losses = {k: v / accum if k.startswith("loss_ce") else v
                              for k, v in losses.items()}
                micro_total = criterion.weighted_total(losses)
            with stage("backward"):
                micro_total.backward()
        total = micro_total.detach() if total is None else total + micro_total.detach()
        for k, v in losses.items():
            sums[k] = v.detach() if k not in sums else sums[k] + v.detach()
    with stage("optimizer"):
        if clip_gradients is not None:
            clip_gradients([p for group in optimizer.param_groups for p in group["params"]])
        optimizer.step()
        scheduler.step()
    metrics = {"total_loss": total, **sums}
    if world > 1:
        values = all_reduce_sum(torch.stack([v.float() for v in metrics.values()])) / world
        metrics = dict(zip(metrics, values.unbind(0)))
    return metrics
