"""StandardTransformerDecoder: MaskFormer-v1's DETR-style decoder (reference
maskformer_transformer_decoder.py:30-171 and DETR's transformer.py,
`mp_former_tpu/models/transformer_decoder/maskformer_transformer_decoder.py`).

One feature level (`TRANSFORMER_IN_FEATURE`), projected to the hidden width
where it differs (or with ENFORCE_INPUT_PROJ), an optional DETR encoder of
ENC_LAYERS layers over it, then DEC_LAYERS decoder layers on zero queries
with the learnable `query_embed` as their position: self-attention,
cross-attention to the feature (no mask), FFN, each with dropout in
training, post- or pre-norm (PRE_NORM). Every layer's output goes through the
shared `transformer.decoder.norm` into the class and mask heads (deep
supervision). The LayerNorms take flax's eps, 1e-6, as the JAX package's
(the reference's take torch's 1e-5). The attentions are plain torch ops, as
the JAX package's XLA computes them: it has no kernel there. State-dict
names are the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils import region_dtype
from ...utils.layers import Conv2d, LayerNorm, c2_xavier_fill, dropout as drop
from ...utils.registry import TRANSFORMER_DECODER_REGISTRY
from ..pixel_decoder.fpn import FLAX_LN_EPS, build_encoder
from .position_encoding import position_embedding_sine
from .primitives import MLP, MultiheadAttention


class TransformerDecoderLayer(nn.Module):
    """DETR's decoder layer (JAX `_DETRDecoderLayer`)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, normalize_before: bool = False):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, fused=False, dropout=dropout)
        self.multihead_attn = MultiheadAttention(d_model, nhead, fused=False, dropout=dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.norm2 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.norm3 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.dropout, self.normalize_before = dropout, normalize_before

    def forward(self, tgt, memory, pos, query_pos, generator: Optional[torch.Generator] = None):
        p, train = self.dropout, self.training

        def self_attend(x):
            qk = x + query_pos
            return drop(self.self_attn(qk, qk, x, generator=generator), p, train, generator)

        def cross_attend(x):
            y = self.multihead_attn(x + query_pos, memory + pos, memory, generator=generator)
            return drop(y, p, train, generator)

        def ffn(x):
            h = drop(F.relu(self.linear1(x)), p, train, generator)
            return drop(self.linear2(h), p, train, generator)

        if self.normalize_before:
            tgt = tgt + self_attend(self.norm1(tgt))
            tgt = tgt + cross_attend(self.norm2(tgt))
            return tgt + ffn(self.norm3(tgt))
        tgt = self.norm1(tgt + self_attend(tgt))
        tgt = self.norm2(tgt + cross_attend(tgt))
        return self.norm3(tgt + ffn(tgt))


class TransformerDecoder(nn.Module):
    def __init__(self, layers, d_model: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = LayerNorm(d_model, eps=FLAX_LN_EPS)


class Transformer(nn.Module):
    """The reference's `transformer` container (`encoder`, `decoder`)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float,
                 normalize_before: bool, enc_layers: int, dec_layers: int):
        super().__init__()
        self.encoder = build_encoder(d_model, nhead, dim_feedforward, dropout, normalize_before,
                                     enc_layers)
        self.decoder = TransformerDecoder(
            [TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout, normalize_before)
             for _ in range(dec_layers)], d_model)
        for p in self.decoder.parameters():
            if p.dim() > 1:
                nn.init.xavier_uniform_(p)


@TRANSFORMER_DECODER_REGISTRY.register()
class StandardTransformerDecoder(nn.Module):
    def __init__(self, in_channels: int, *, num_classes: int, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8, dropout: float = 0.1,
                 dim_feedforward: int = 2048, enc_layers: int = 0, dec_layers: int = 6,
                 pre_norm: bool = False, deep_supervision: bool = True, mask_dim: int = 256,
                 enforce_input_project: bool = False):
        super().__init__()
        self.hidden_dim, self.num_queries = hidden_dim, num_queries
        self.deep_supervision = deep_supervision
        self.transformer = Transformer(hidden_dim, nheads, dim_feedforward, dropout, pre_norm,
                                       enc_layers, dec_layers)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        if in_channels != hidden_dim or enforce_input_project:
            self.input_proj = Conv2d(in_channels, hidden_dim, kernel_size=1)
            c2_xavier_fill(self.input_proj)
        else:
            self.input_proj = nn.Sequential()
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    @classmethod
    def from_config(cls, cfg, in_channels):
        mf = cfg.MODEL.MASK_FORMER
        return cls(in_channels, num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                   hidden_dim=mf.HIDDEN_DIM, num_queries=mf.NUM_OBJECT_QUERIES,
                   nheads=mf.NHEADS, dropout=mf.DROPOUT, dim_feedforward=mf.DIM_FEEDFORWARD,
                   enc_layers=mf.ENC_LAYERS, dec_layers=mf.DEC_LAYERS, pre_norm=mf.PRE_NORM,
                   deep_supervision=mf.DEEP_SUPERVISION,
                   enforce_input_project=mf.ENFORCE_INPUT_PROJ,
                   mask_dim=cfg.MODEL.SEM_SEG_HEAD.MASK_DIM)

    def forward(self, x: List[torch.Tensor], mask_features: torch.Tensor, dn_args=None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """x: [one feature map (B, C, h, w)]; mask_features (B, mask_dim,
        H/4, W/4). `dn_args` is accepted and not read: the decoder has no DN
        queries, and the dict carries no `dn_out`. `generator` feeds the
        dropout in training mode."""
        feat = self.input_proj(x[0])
        b, c, h, w = feat.shape
        src = feat.flatten(2).transpose(1, 2)
        pos = position_embedding_sine(h, w, c // 2, device=feat.device,
                                      dtype=src.dtype).reshape(1, h * w, c)
        src = self.transformer.encoder(src, pos, generator)
        query_pos = self.query_embed.weight[None].expand(b, -1, -1).to(
            region_dtype(feat.device.type))
        tgt = torch.zeros_like(query_pos)
        decoder = self.transformer.decoder
        hs = []
        for layer in decoder.layers:
            tgt = layer(tgt, src, pos, query_pos, generator)
            hs.append(decoder.norm(tgt))
        if not self.deep_supervision:
            hs = hs[-1:]
        logits = [self.class_embed(q) for q in hs]
        masks = [torch.einsum("bqc,bchw->bqhw", self.mask_embed(q), mask_features) for q in hs]
        return {"pred_logits": logits[-1], "pred_masks": masks[-1],
                "aux_outputs": [{"pred_logits": a, "pred_masks": m}
                                for a, m in zip(logits[:-1], masks[:-1])]}
