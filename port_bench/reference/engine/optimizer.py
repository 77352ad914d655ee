"""Optimizer and LR schedule (reference train_net.py:250-337,
`mp_former_tpu/engine/optimizer.py`).

The d2 parameter-group rules as `torch.optim` parameter groups:
- backbone parameters: LR x `SOLVER.BACKBONE_MULTIPLIER`;
- parameters of norm modules (LayerNorm, GroupNorm): `SOLVER.WEIGHT_DECAY_NORM`;
- embedding tables (`query_feat`, `level_embed`, `label_enc`, also the pixel
  decoder's `level_embed` parameter, as the JAX package groups it):
  `SOLVER.WEIGHT_DECAY_EMBED`;
- `MODEL.BACKBONE.FREEZE_AT` (1 = stem, 2 = stem + res2, ...; a Swin's
  patch embedding, then its stages, as the JAX package masks them) as
  `requires_grad = False`; FrozenBN statistics are buffers and never train;
- full-model gradient clipping by the global norm at `CLIP_VALUE`.

The JAX package's optax chain adds `wd * p` after `scale_by_adam` and before
the LR, which is decoupled decay scaled by the LR: `torch.optim.AdamW`'s rule.
Two things differ from the JAX package, both on the reference's side. Frozen
parameters have no gradient here, so they are not in the clipped norm (the JAX
package zeroes their updates but counts their gradients). And SGD is
`torch.optim.SGD`, which puts the decay into the momentum (optax's chain there
adds it after).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch
from torch import nn

_EMBED_TOKENS = ("query_feat", "query_embed", "level_embed", "label_enc",
                 "absolute_pos_embed", "relative_position_bias_table")
_NORM_MODULES = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)


def multi_step_schedule(base_lr, steps, gamma=0.1, warmup_iters=10, warmup_factor=1.0):
    """d2 WarmupMultiStepLR: step count -> LR."""
    steps = tuple(steps)

    def sched(count: int) -> float:
        lr = float(base_lr)
        for s in steps:
            if count >= s:
                lr *= gamma
        if warmup_iters > 0 and warmup_factor < 1.0:
            alpha = min(max(count / warmup_iters, 0.0), 1.0)
            lr *= warmup_factor * (1 - alpha) + alpha
        return lr

    return sched


def poly_schedule(base_lr, max_iter, power=0.9, constant_ending=0.0, warmup_iters=1000,
                  warmup_factor=1e-3):
    """d2 WarmupPolyLR (the semantic-segmentation recipes): step count -> LR."""

    def sched(count: int) -> float:
        frac = min(max(count / max_iter, 0.0), 1.0)
        lr = base_lr * max((1.0 - frac) ** power, constant_ending)
        if warmup_iters > 0:
            alpha = min(max(count / warmup_iters, 0.0), 1.0)
            lr *= warmup_factor * (1 - alpha) + alpha
        return lr

    return sched


def build_lr_schedule(cfg) -> Callable[[int], float]:
    s = cfg.SOLVER
    if s.LR_SCHEDULER_NAME == "WarmupMultiStepLR":
        return multi_step_schedule(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_ITERS, s.WARMUP_FACTOR)
    if s.LR_SCHEDULER_NAME == "WarmupPolyLR":
        return poly_schedule(s.BASE_LR, s.MAX_ITER, s.POLY_LR_POWER, s.POLY_LR_CONSTANT_ENDING,
                             s.WARMUP_ITERS, s.WARMUP_FACTOR)
    raise ValueError(f"Unknown LR scheduler {s.LR_SCHEDULER_NAME}")


def freeze_backbone(model: nn.Module, freeze_at: int) -> None:
    """d2's FREEZE_AT: the stem (>= 1) and the stages res2.. up to `freeze_at`
    stop training. A Swin is frozen by the JAX package's masks
    (`mp_former_tpu/engine/optimizer.py:151-167`; the reference's Swin reads
    no FREEZE_AT): its patch embedding and absolute position embedding (>= 1)
    and `layers.{s-2}` (blocks and patch merging) for each stage s up to
    `freeze_at`; the output norms `norm{i}` always train."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "backbone" or len(parts) < 2:
            continue
        stage = parts[1]
        if stage == "layers":
            stage = f"res{int(parts[2]) + 2}"
        if (freeze_at >= 1 and stage in ("stem", "patch_embed", "absolute_pos_embed")) or any(
                freeze_at >= s and stage == f"res{s}" for s in range(2, 6)):
            p.requires_grad_(False)


def param_groups(cfg, model: nn.Module) -> List[dict]:
    """One group per (LR multiplier, weight decay) in use, over the
    parameters that train; `names` lists each group's members."""
    s = cfg.SOLVER
    groups = {}
    for module_name, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            name = f"{module_name}.{pname}" if module_name else pname
            if isinstance(module, _NORM_MODULES):
                wd = s.WEIGHT_DECAY_NORM
            elif any(tok in name for tok in _EMBED_TOKENS):
                wd = s.WEIGHT_DECAY_EMBED
            else:
                wd = s.WEIGHT_DECAY
            mult = s.BACKBONE_MULTIPLIER if name.startswith("backbone.") else 1.0
            g = groups.setdefault((mult, wd), {"params": [], "names": [], "lr": mult,
                                               "weight_decay": wd})
            g["params"].append(p)
            g["names"].append(name)
    return list(groups.values())


def build_optimizer(cfg, model: nn.Module):
    """(optimizer, scheduler) of reference Trainer.build_optimizer
    (train_net.py:258-337). A group's `lr` is the schedule's LR times the
    group's multiplier; call `scheduler.step()` after each `optimizer.step()`."""
    s = cfg.SOLVER
    freeze_backbone(model, cfg.MODEL.BACKBONE.FREEZE_AT)
    groups = param_groups(cfg, model)
    if s.OPTIMIZER == "ADAMW":
        optimizer = torch.optim.AdamW(groups, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    elif s.OPTIMIZER == "SGD":
        optimizer = torch.optim.SGD(groups, lr=1.0, momentum=s.MOMENTUM, nesterov=s.NESTEROV)
    else:
        raise NotImplementedError(f"no optimizer type {s.OPTIMIZER}")
    # a group's initial lr is its multiplier, the lambda the schedule's LR
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, build_lr_schedule(cfg))
    return optimizer, scheduler


def build_gradient_clipper(cfg) -> Optional[Callable[[Iterable[torch.Tensor]], None]]:
    """SOLVER.CLIP_GRADIENTS as a function of the parameters, or None:
    'full_model' and 'norm' clip by the global norm (as the JAX package reads
    both), 'value' clips each entry."""
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.ENABLED:
        return None
    if c.CLIP_TYPE in ("full_model", "norm"):
        return lambda params: nn.utils.clip_grad_norm_(params, c.CLIP_VALUE)
    if c.CLIP_TYPE == "value":
        return lambda params: nn.utils.clip_grad_value_(params, c.CLIP_VALUE)
    raise ValueError(f"Unknown SOLVER.CLIP_GRADIENTS.CLIP_TYPE {c.CLIP_TYPE}")
