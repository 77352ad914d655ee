"""Hungarian matcher (reference modeling/matcher.py:70-189,
`mp_former_tpu/models/matcher.py`).

The costs are computed on the device over `num_points` random points shared by
an image's predictions and targets; the assignment is solved on the host with
scipy under `no_grad`, as the reference does. Targets are padded to N slots
with a validity mask: invalid columns cost just above the worst real cost, and
the returned assignment is a permutation, so valid and invalid slots never
collide. (The JAX package also has an on-device auction solver,
`ops/auction_lsa.py`, for a runtime without host callbacks; it is not ported.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.optimize
import torch
import torch.nn.functional as F

from ..structures import Targets
from ..utils.interp import point_sample

_INVALID_COST = 1e6


def uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform [0, 1) draws on `device` from `generator` (on whatever device the
    generator lives), or from the global generator when there is none."""
    if generator is None:
        return torch.rand(shape, device=device)
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def lsa_host(cost: np.ndarray) -> np.ndarray:
    """cost (M, Q, N) -> (M, N) int64: the query assigned to each target column."""
    cost = np.asarray(cost, dtype=np.float64)
    m, _, n = cost.shape
    out = np.zeros((m, n), dtype=np.int64)
    for i in range(m):
        rows, cols = scipy.optimize.linear_sum_assignment(cost[i])
        out[i, cols] = rows
    return out


def fill_invalid_columns(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Non-finite entries become 1e6 and invalid target columns a cost just
    above the worst real cost of their image. cost (B, Q, N), valid (B, N)."""
    cost = torch.where(torch.isfinite(cost), cost, cost.new_tensor(_INVALID_COST))
    v = valid[:, None, :]
    ceiling = cost.masked_fill(~v, -torch.inf).amax(dim=(1, 2), keepdim=True)
    ceiling = torch.where(torch.isfinite(ceiling), ceiling, torch.zeros_like(ceiling)) + 1.0
    return torch.where(v, cost, ceiling)


def batch_dice_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(..., Q, P) logits x (..., N, P) binary -> (..., Q, N) (reference :17-31)."""
    inputs = inputs.sigmoid()
    numerator = 2 * torch.einsum("...qp,...np->...qn", inputs, targets)
    denominator = inputs.sum(-1)[..., :, None] + targets.sum(-1)[..., None, :]
    return 1 - (numerator + 1) / (denominator + 1)


def batch_sigmoid_ce_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(..., Q, P) logits x (..., N, P) binary -> (..., Q, N) (reference :39-62)."""
    p = inputs.shape[-1]
    pos = F.softplus(-inputs)  # BCE(x, 1)
    neg = F.softplus(inputs)   # BCE(x, 0)
    loss = (torch.einsum("...qp,...np->...qn", pos, targets)
            + torch.einsum("...qp,...np->...qn", neg, 1 - targets))
    return loss / p


def match_cost_matrix(pred_logits: torch.Tensor, pred_masks: torch.Tensor, targets: Targets,
                      num_points: int, cost_class: float, cost_mask: float, cost_dice: float,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """pred_logits (B, Q, K+1), pred_masks (B, Q, h, w) logits -> (B, Q, N)
    matching cost at `num_points` points (B, num_points, 2) in [0, 1] as
    (x, y), drawn from `generator`."""
    b = pred_logits.shape[0]
    prob = pred_logits.float().softmax(-1)
    cc = -torch.gather(prob, 2, targets.labels[:, None, :].expand(-1, prob.shape[1], -1))
    coords = uniform((b, num_points, 2), generator, pred_logits.device)
    out_pts = point_sample(pred_masks.float().permute(0, 2, 3, 1), coords).transpose(1, 2)
    tgt_pts = point_sample(targets.masks.float().permute(0, 2, 3, 1), coords).transpose(1, 2)
    cm = batch_sigmoid_ce_cost(out_pts, tgt_pts)
    cd = batch_dice_cost(out_pts, tgt_pts)
    cost = cost_mask * cm + cost_class * cc + cost_dice * cd
    return fill_invalid_columns(cost, targets.valid)


class HungarianMatcher:
    """Holds the cost weights (reference HungarianMatcher :70-110)."""

    def __init__(self, cost_class: float = 1.0, cost_mask: float = 1.0, cost_dice: float = 1.0,
                 num_points: int = 0):
        if cost_class == 0 and cost_mask == 0 and cost_dice == 0:
            raise ValueError("all matching costs are 0")
        self.cost_class = cost_class
        self.cost_mask = cost_mask
        self.cost_dice = cost_dice
        self.num_points = num_points

    def cost(self, pred_logits, pred_masks, targets: Targets, generator=None):
        return match_cost_matrix(pred_logits, pred_masks, targets, self.num_points,
                                 self.cost_class, self.cost_mask, self.cost_dice,
                                 generator=generator)
