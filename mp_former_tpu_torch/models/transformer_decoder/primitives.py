"""Transformer building blocks (reference mask2former_transformer_decoder.py:19-206,
`mp_former_tpu/models/transformer_decoder/primitives.py`).

`MultiheadAttention` keeps `nn.MultiheadAttention`'s state-dict names
(`in_proj_weight`, `in_proj_bias`, `out_proj`) with a batch-first interface.
Cross-attention (`fused=True`; the JAX package's `fused_attn` marks the same layers) with
a mask goes through `ops/masked_attention_cuda.py:masked_attention`: the
hand-written kernel K3 on CUDA (with its backward kernel in training), its
plain version on the CPU; masked logits are -1e9, not -inf. K3 takes q, k and
v as the (B, H, N, D) views of the (B, N, H, D) projections (last dimension
contiguous, rows on 16-byte boundaries), so no head is copied, and returns its
result in (B, Q, H, D) order, so merging the heads is a view too.
Self-attention is plain einsum + softmax, as in the JAX package, which sends
only cross-attention to its kernel: without a mask at inference, and in DN
training with the (Q, Q) mask that separates the DN groups, blocked logits set
to -1e9. The layers are post-norm, as in every recipe of configs/ (`PRE_NORM
False`). The recipes train with `DROPOUT 0.0` and the JAX decoder hard-codes
0.0; the port carries no dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.masked_attention_cuda import masked_attention

_NEG_INF = -1e9


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, fused: bool = True):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by num_heads {num_heads}")
        self.embed_dim, self.num_heads, self.fused = embed_dim, num_heads, fused
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.in_proj_bias)
        nn.init.zeros_(self.out_proj.bias)

    def _heads(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Project with the i-th slice of in_proj and split heads: the
        (B, N, H, D) projection seen as (B, H, N, D), a view without a copy."""
        C, H = self.embed_dim, self.num_heads
        y = F.linear(x, self.in_proj_weight[i * C:(i + 1) * C], self.in_proj_bias[i * C:(i + 1) * C])
        return y.view(x.shape[0], x.shape[1], H, C // H).transpose(1, 2)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Q, C), key/value (B, S, C); attn_mask bool, True = blocked:
        (B, Q, S) shared by the heads or (B, H, Q, S), and for the plain route
        also (Q, S) shared by the batch."""
        B, Q, C = query.shape
        q, k, v = self._heads(query, 0), self._heads(key, 1), self._heads(value, 2)
        if self.fused and attn_mask is not None:
            # the kernel takes the strided views and writes (B, Q, H, D) order
            out = masked_attention(q, k, v, attn_mask)
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            logits = torch.einsum("bhqd,bhsd->bhqs", q, k) / math.sqrt(q.shape[-1])
            if attn_mask is not None:
                m = attn_mask[:, None] if attn_mask.dim() == 3 else attn_mask
                logits = logits.masked_fill(m, _NEG_INF)
            out = torch.einsum("bhqs,bhsd->bhqd", logits.softmax(dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, Q, C))


def _xavier_matrices(module: nn.Module) -> None:
    for p in module.parameters():
        if p.dim() > 1:
            nn.init.xavier_uniform_(p)


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, fused=False)
        self.norm = nn.LayerNorm(d_model)
        _xavier_matrices(self)

    def forward(self, tgt, tgt_mask: Optional[torch.Tensor] = None):
        return self.norm(tgt + self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model)
        _xavier_matrices(self)

    def forward(self, tgt, memory, memory_mask, pos):
        return self.norm(tgt + self.multihead_attn(tgt, memory + pos, memory, attn_mask=memory_mask))


class FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int = 2048):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model)
        _xavier_matrices(self)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


class MLP(nn.Module):
    """DETR-style MLP (reference :193-206)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
