"""Seeded weights, made on the card in a few large draws and handed alike to
the port and to the reference.

The names and shapes come from the reference's state dict (the port keeps
the same names); the draw is one normal sample the size of all float
tensors together, from a `torch.Generator` on the device, then scaled per
tensor: a matrix or kernel by 1 / sqrt(fan-in), a norm's scale around 1, a
bias or a shift around 0, a relative-position bias table at 0.02. Integer
buffers (index tables) are the model's own and are not drawn."""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

_SMALL = ("relative_position_bias_table",)


def _is_norm(module: nn.Module) -> bool:
    return isinstance(module, (nn.LayerNorm, nn.GroupNorm)) or \
        type(module).__name__ == "FrozenBatchNorm2d"


def drawn_names(model: nn.Module) -> Dict[str, torch.Size]:
    """The float tensors of `model`'s state dict that are drawn, with their
    shapes: every parameter and the frozen batch norms' statistics."""
    out = {}
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        tensors = dict(module.named_parameters(recurse=False))
        if type(module).__name__ == "FrozenBatchNorm2d":
            tensors.update(module.named_buffers(recurse=False))
        for name, t in tensors.items():
            if t.is_floating_point():
                out[prefix + name] = (t.shape, _is_norm(module))
    return out


def make_weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for every drawn tensor of `model`
    (which may live on the meta device), from `seed`."""
    names = drawn_names(model)
    total = sum(math.prod(shape) for shape, _ in names.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, (shape, norm) in names.items():
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if any(s in name for s in _SMALL):
            x = x * 0.02
        elif leaf == "running_var":
            x = 1.0 + 0.1 * x.abs()
        elif norm and leaf == "weight":
            x = 1.0 + 0.1 * x
        elif len(shape) >= 2:
            x = x * (1.0 / math.sqrt(n // shape[0]))
        else:
            x = x * 0.02
        out[name] = x
    return out


def load(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `model`, which has to hold exactly these drawn
    tensors (a name missing on either side raises)."""
    mine = drawn_names(model)
    if set(mine) != set(weights):
        raise KeyError(f"weights and model differ: only in the model "
                       f"{sorted(set(mine) - set(weights))[:5]}, only in the weights "
                       f"{sorted(set(weights) - set(mine))[:5]}")
    state = dict(model.named_parameters())
    state.update(dict(model.named_buffers()))
    with torch.no_grad():
        for name, value in weights.items():
            if state[name].shape != value.shape:
                raise ValueError(f"{name}: model {tuple(state[name].shape)}, weights "
                                 f"{tuple(value.shape)}")
            state[name].copy_(value)
