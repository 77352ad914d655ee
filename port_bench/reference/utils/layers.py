"""detectron2's `Conv2d` wrapper: a conv with an attached `.norm` and
activation, so the reference's state-dict names (`<conv>.weight`,
`<conv>.norm.*`) carry over; a LayerNorm that returns the compute type; and
dropout as flax's `nn.Dropout` computes it.

Dropout (`dropout`, `keep_mask`) is torch's inverted dropout: an entry is
kept with probability 1 - rate and divided by 1 - rate, else 0. Its masks
come from an explicit `torch.Generator` (the one the model's `forward`
takes, as the DN noise does), and every mask of the port is drawn by
`keep_mask`, so a test can hand the port the JAX package's own draws
(`jax.random.bernoulli`) in order. A caller that recomputes a layer in the
backward (`TPU.REMAT_ENCODER`) draws the layer's masks before the recomputed
region and passes them in, so the recompute drops what the forward dropped.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn



class Conv2d(nn.Conv2d):
    def __init__(self, *args, norm: Optional[nn.Module] = None,
                 activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` whose result is in the compute region's type, as flax's
    `LayerNorm(dtype=...)` of the JAX package is: statistics in float32, the
    output rounded to bfloat16 under bfloat16 (CUDA's autocast would leave it
    float32, the CPU's in the input's type). Outside a region, unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        device_type = x.device.type
        if torch.is_autocast_enabled(device_type):
            return y.to(torch.get_autocast_dtype(device_type))
        return y


def c2_xavier_fill(module: nn.Module) -> None:
    """Caffe2's XavierFill (detectron2 weight_init.c2_xavier_fill)."""
    nn.init.kaiming_uniform_(module.weight, a=1)
    if module.bias is not None:
        nn.init.zeros_(module.bias)


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """bool (shape): True where dropout keeps an entry, each with probability
    1 - rate (flax's `random.bernoulli(key, 1 - rate, shape)`), drawn from
    `generator` (on whatever device it lives) or the global generator."""
    if generator is None:
        u = torch.rand(shape, device=device)
    else:
        u = torch.rand(shape, generator=generator, device=generator.device).to(device)
    return u < 1.0 - rate


def keep_masks(shapes: Sequence[Tuple[int, ...]], rate: float,
               generator: Optional[torch.Generator], device) -> Tuple[torch.Tensor, ...]:
    """One `keep_mask` a shape, drawn in the order given."""
    return tuple(keep_mask(s, rate, generator, device) for s in shapes)


def apply_keep(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """x where `keep`, divided by 1 - rate, and 0 elsewhere (flax's
    `select(mask, x / keep_prob, 0)`); x itself where `keep` is None."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dropout of `x` at `rate` in training (`train`), drawn now; x itself
    in eval mode or at rate 0."""
    if not train or rate == 0.0:
        return x
    return apply_keep(x, keep_masks([x.shape], rate, generator, x.device)[0], rate)
