"""Mask2Former / MP-Former MaskDN transformer decoder, inference path
(`mp_former_tpu/models/transformer_decoder/mask2former_decoder.py`).

MP-Former's mask-piloted (DN) queries exist only in training; at inference
the MaskDN decoder is plain Mask2Former (reference
mask2former_transformer_decoder.py:1779-1856): learnable queries, 9 layers
that cycle over the 3 scales (`i % 3`), each masked cross-attention ->
self-attention -> FFN, with the next layer's attention mask taken from the
current mask prediction (bilinear resize to the next level, sigmoid < 0.5,
the same mask for every head). A row whose keys are all blocked attends
everywhere instead (reference :1780). Training and DN are not ported yet and
raise.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ...utils.interp import resize
from ...utils.layers import Conv2d, c2_xavier_fill
from ...utils.registry import TRANSFORMER_DECODER_REGISTRY
from .position_encoding import position_embedding_sine
from .primitives import MLP, CrossAttentionLayer, FFNLayer, SelfAttentionLayer


def build_transformer_decoder(cfg, in_channels):
    """Registry dispatch (reference maskformer_transformer_decoder.py:22-27)."""
    name = cfg.MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME
    return TRANSFORMER_DECODER_REGISTRY.get(name).from_config(cfg, in_channels)


@TRANSFORMER_DECODER_REGISTRY.register()
class MultiScaleMaskedTransformerDecoderMaskDN(nn.Module):
    # the MaskDN decoder carries the DN label embedding (unused at inference)
    has_label_enc = True

    def __init__(self, in_channels: int, *, num_classes: int, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, mask_dim: int = 256,
                 enforce_input_project: bool = False, num_feature_levels: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers, self.num_feature_levels = dec_layers, num_feature_levels
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, nheads) for _ in range(dec_layers))
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, nheads) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim, dim_feedforward) for _ in range(dec_layers))
        self.decoder_norm = nn.LayerNorm(hidden_dim)
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(num_feature_levels, hidden_dim)
        self.input_proj = nn.ModuleList()
        for _ in range(num_feature_levels):
            if in_channels != hidden_dim or enforce_input_project:
                conv = Conv2d(in_channels, hidden_dim, kernel_size=1)
                c2_xavier_fill(conv)
                self.input_proj.append(conv)
            else:
                self.input_proj.append(nn.Sequential())
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)
        if self.has_label_enc:
            self.label_enc = nn.Embedding(num_classes, hidden_dim)

    @classmethod
    def from_config(cls, cfg, in_channels):
        mf = cfg.MODEL.MASK_FORMER
        if mf.PRE_NORM:
            raise NotImplementedError("MODEL.MASK_FORMER.PRE_NORM: no recipe uses pre-norm "
                                      "decoder layers and the port has post-norm only")
        return cls(
            in_channels,
            num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
            hidden_dim=mf.HIDDEN_DIM,
            num_queries=mf.NUM_OBJECT_QUERIES,
            nheads=mf.NHEADS,
            dim_feedforward=mf.DIM_FEEDFORWARD,
            dec_layers=mf.DEC_LAYERS - 1,  # reference from_config: one is the query loss
            mask_dim=cfg.MODEL.SEM_SEG_HEAD.MASK_DIM,
            enforce_input_project=mf.ENFORCE_INPUT_PROJ,
        )

    def forward_prediction_heads(self, output: torch.Tensor, mask_features: torch.Tensor,
                                 attn_mask_target_size):
        """(B, Q, C) queries -> class logits (B, Q, K+1), mask logits
        (B, Q, H/4, W/4) and the next attention mask (B, Q, h*w) bool,
        True = blocked, shared by the heads (reference :1859-1877)."""
        dec = self.decoder_norm(output)
        outputs_class = self.class_embed(dec)
        mask_embed = self.mask_embed(dec)
        outputs_mask = torch.einsum("bqc,bchw->bqhw", mask_embed, mask_features)
        attn_mask = resize(outputs_mask, attn_mask_target_size, "bilinear")
        attn_mask = attn_mask.sigmoid().flatten(2) < 0.5
        return outputs_class, outputs_mask, attn_mask

    def forward(self, x: List[torch.Tensor], mask_features: torch.Tensor,
                dn_args=None) -> Dict:
        """x: the pixel decoder's [1/32, 1/16, 1/8] maps (B, C, h, w);
        mask_features (B, mask_dim, H/4, W/4)."""
        if dn_args is not None:
            raise NotImplementedError("DN training is ROADMAP slice 3; the port runs inference")
        if len(x) != self.num_feature_levels:
            raise ValueError(f"expected {self.num_feature_levels} levels, got {len(x)}")
        B, C = x[0].shape[0], self.hidden_dim
        src, pos, size_list = [], [], []
        for i, xi in enumerate(x):
            h, w = xi.shape[-2:]
            size_list.append((h, w))
            pe = position_embedding_sine(h, w, C // 2, device=xi.device, dtype=xi.dtype)
            pos.append(pe.reshape(1, h * w, C))
            src.append(self.input_proj[i](xi).flatten(2).transpose(1, 2)
                       + self.level_embed.weight[i][None, None])

        output = self.query_feat.weight[None].expand(B, -1, -1)
        outputs_class, outputs_mask, attn_mask = self.forward_prediction_heads(
            output, mask_features, size_list[0])
        predictions_class, predictions_mask = [outputs_class], [outputs_mask]
        for i in range(self.num_layers):
            level_index = i % self.num_feature_levels
            # degenerate all-blocked rows attend everywhere (reference :1780)
            attn_mask = attn_mask & ~attn_mask.all(dim=-1, keepdim=True)
            output = self.transformer_cross_attention_layers[i](
                output, src[level_index], attn_mask, pos[level_index])
            output = self.transformer_self_attention_layers[i](output)
            output = self.transformer_ffn_layers[i](output)
            outputs_class, outputs_mask, attn_mask = self.forward_prediction_heads(
                output, mask_features, size_list[(i + 1) % self.num_feature_levels])
            predictions_class.append(outputs_class)
            predictions_mask.append(outputs_mask)
        return {
            "pred_logits": predictions_class[-1],
            "pred_masks": predictions_mask[-1],
            "aux_outputs": [{"pred_logits": a, "pred_masks": b}
                            for a, b in zip(predictions_class[:-1], predictions_mask[:-1])],
        }


@TRANSFORMER_DECODER_REGISTRY.register()
class MultiScaleMaskedTransformerDecoder(MultiScaleMaskedTransformerDecoderMaskDN):
    """Vanilla Mask2Former decoder (reference :209-555): no DN label embedding."""

    has_label_enc = False
