"""One training step in one process, without micro-batches: a frozen copy of
the port's `engine/train_step.py` (global num_masks, forward with the
mask-piloted queries, the matcher's costs, the host's assignment, the
losses, the weighted total, backward, clip, AdamW, the schedule). The
generator feeds the DN noise, the matcher's points and the loss's point
sampling, in that order, as in the port, so a reference seeded alike draws
the same numbers."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..structures import Batch


def train_step(model, criterion, optimizer, scheduler, batch: Batch,
               generator: Optional[torch.Generator] = None,
               clip_gradients: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Forward, losses, backward, clip, update; the detached loss dict and
    `total_loss`."""
    valid = batch.targets.valid
    num_masks = valid.sum().float().clamp(min=1.0)
    optimizer.zero_grad(set_to_none=True)
    outputs = model(batch.images, batch.targets, generator=generator)
    costs = criterion.layer_costs(outputs, batch.targets, generator)
    assignments = criterion.assign(costs)
    losses = criterion(outputs, batch.targets, generator, num_masks=num_masks,
                       assignments=assignments)
    del outputs
    total = criterion.weighted_total(losses)
    total.backward()
    if clip_gradients is not None:
        clip_gradients([p for group in optimizer.param_groups for p in group["params"]])
    optimizer.step()
    scheduler.step()
    return {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
