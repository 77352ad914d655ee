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
"""

from __future__ import annotations

from typing import Callable, ContextManager, Dict, Iterator, Optional, Tuple

import torch
from torch.profiler import record_function

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
    targets = batch.targets
    # the valid instances of the global batch (reference all_reduce, criterion.py:235-237)
    num_masks = targets.valid.sum().float().clamp(min=1.0)
    dn_groups = compute_dn_groups(model.scalar, targets.valid, dn_group_bucket)
    optimizer.zero_grad(set_to_none=True)
    total, sums = None, {}
    for micro in micro_batches(batch, accum):
        with stage("forward"):
            outputs = model(micro.images, micro.targets, dn_groups=dn_groups,
                            generator=generator)
        with stage("matcher_costs"):
            costs = criterion.layer_costs(outputs, micro.targets, generator)
        with stage("matcher_host"):
            assignments = criterion.assign(costs)
        with stage("losses"):
            losses = criterion(outputs, micro.targets, generator, num_masks=num_masks,
                               assignments=assignments)
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
    return {"total_loss": total, **sums}
