"""The plain kernels one image at a time where autograd records, each image
recomputed in the backward (`torch.utils.checkpoint`), so that the
reference's training step holds one image's gathers or attention weights at
a time instead of the batch's. The arithmetic of every image is the same as
in one call over the batch."""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import checkpoint


def per_image(fn: Callable[..., torch.Tensor], static: int = -1) -> Callable[..., torch.Tensor]:
    """`fn(*args)` over the batch, computed image by image under a
    checkpoint where a gradient is recorded; argument `static` (an index, or
    -1 for none) is passed whole, every other tensor argument is cut along
    its first axis."""

    def run(*args):
        tensors = [a for i, a in enumerate(args) if i != static]
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
            return fn(*args)
        batch = tensors[0].shape[0]
        outs = []
        for b in range(batch):
            part = [a if i == static else a[b:b + 1] for i, a in enumerate(args)]
            outs.append(checkpoint.checkpoint(fn, *part, use_reentrant=False))
        return torch.cat(outs, 0)

    return run
