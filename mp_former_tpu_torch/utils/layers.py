"""detectron2's `Conv2d` wrapper: a conv with an attached `.norm` and
activation, so the reference's state-dict names (`<conv>.weight`,
`<conv>.norm.*`) carry over; a LayerNorm that returns the compute type."""

from __future__ import annotations

from typing import Callable, Optional

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
