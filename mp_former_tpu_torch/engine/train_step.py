"""One training step (`mp_former_tpu/engine/train_step.py:37-140` at
`accum == 1`): global num_masks, forward with DN queries, criterion, weighted
total, backward, clip, optimizer step. `TPU.GRAD_ACCUM_STEPS`, `SPLIT_STEP`,
`HOST_ACCUM`, `DONATE` and the two-phase host matcher of the JAX package are
not ported (the matcher here is on the host already).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

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


def train_step(model, criterion, optimizer, scheduler, batch: Batch,
               generator: Optional[torch.Generator] = None,
               clip_gradients: Optional[Callable] = None,
               dn_group_bucket: int = 1) -> Dict[str, torch.Tensor]:
    """Forward, losses, backward, clip, update; returns the (detached) loss
    dict with the reference's keys and `total_loss`. `generator` feeds the DN
    noise, the matcher's points and the loss's point sampling, in that order."""
    targets = batch.targets
    # the valid instances of the global batch (reference all_reduce, criterion.py:235-237)
    num_masks = targets.valid.sum().float().clamp(min=1.0)
    dn_groups = compute_dn_groups(model.scalar, targets.valid, dn_group_bucket)
    outputs = model(batch.images, targets, dn_groups=dn_groups, generator=generator)
    losses = criterion(outputs, targets, generator, num_masks=num_masks)
    total = criterion.weighted_total(losses)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    if clip_gradients is not None:
        clip_gradients([p for group in optimizer.param_groups for p in group["params"]])
    optimizer.step()
    scheduler.step()
    return {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
