"""Masked cross-attention in plain PyTorch: a frozen copy of the port's plain
version of K3 (`masked_attention_plain`), the reference's arithmetic. Autograd
of the plain ops gives the backward. `count.k3` sees every call."""

from __future__ import annotations

import math

import torch

from ... import flops as count
from .chunks import per_image

_NEG_INF = -1e9


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """einsum + masked_fill(-1e9) + softmax + einsum."""
    logits = torch.einsum("bhqd,bhsd->bhqs", q, k) / math.sqrt(q.shape[-1])
    m = mask[:, None] if mask.dim() == 3 else mask
    attn = logits.masked_fill(m, _NEG_INF).softmax(dim=-1)
    return torch.einsum("bhqs,bhsd->bhqd", attn, v)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """q (B, H, Q, D), k and v (B, H, S, D), mask (B, Q, S) or (B, H, Q, S),
    True where a key is masked out -> (B, H, Q, D)."""
    return count.k3(per_image(masked_attention_plain), q, k, v, mask)
