"""Mask2Former / MP-Former MaskDN transformer decoder
(`mp_former_tpu/models/transformer_decoder/mask2former_decoder.py`), as the
benchmark's configurations run it.

At inference the MaskDN decoder is plain Mask2Former (reference
mask2former_transformer_decoder.py:1779-1856): learnable queries, 9 layers
that cycle over the 3 scales (`i % 3`), each masked cross-attention ->
self-attention -> FFN, with the next layer's attention mask taken from the
current mask prediction (bilinear resize to the next level, sigmoid < 0.5,
the same mask for every head). A row whose keys are all blocked attends
everywhere instead (reference :1780). `PRE_NORM` makes the layers pre-norm.

In training (`dn_args` given) MP-Former's mask-piloted queries are put in
front of the learnable ones: `scalar` groups of N queries, one per padded
ground-truth slot; a self-attention mask keeps the groups apart and hides
them from the learnable queries (:1051-1059). Slots without an instance carry
zero content and fully blocked rows, and the losses leave them out. The DN
rows are those of `DN_MODE points`, the released recipe's (reference
`prepare_for_dn_v5` :968): their cross-attention masks are the
area-downsampled ground truth, each entry flipped with a probability
proportional to the mask's area (`gen_mask_dn` :1584-1622), shared by the
heads; their content is the class-flipped (`LB_NOISE_RATIO`) label
embedding. Fresh ground-truth masks go into the DN rows at every layer under
ALL_LY_DN, else in the first three. The noise is drawn from the forward's
`generator` through `models/matcher.py:uniform`, in the JAX decoder's order:
the label flips and their values, then one point-noise tensor a refresh.

The attention mask is (B, Q, S), shared by the heads. K3 takes it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ...structures import DNArgs
from ...utils import float32_region, region_dtype
from ...utils.interp import resize
from ...utils.layers import Conv2d, LayerNorm, c2_xavier_fill
from .position_encoding import position_embedding_sine
from ..matcher import uniform
from .primitives import MLP, CrossAttentionLayer, FFNLayer, SelfAttentionLayer

def build_transformer_decoder(cfg, in_channels):
    """The decoder that MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME names
    (reference maskformer_transformer_decoder.py:22-27)."""
    name = cfg.MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME
    decoders = {c.__name__: c for c in (MultiScaleMaskedTransformerDecoderMaskDN,
                                        MultiScaleMaskedTransformerDecoder)}
    if name not in decoders:
        raise ValueError(f"TRANSFORMER_DECODER_NAME {name!r} is none of {sorted(decoders)}")
    return decoders[name].from_config(cfg, in_channels)


def _dn_tgt_mask(scalar: int, single_pad: int, num_queries: int) -> torch.Tensor:
    """(T, T) bool self-attention mask, True = blocked (reference :1051-1059):
    the learnable queries do not see the DN queries, and a DN group sees only
    itself and the learnable queries."""
    pad = scalar * single_pad
    m = torch.zeros((pad + num_queries, pad + num_queries), dtype=torch.bool)
    m[pad:, :pad] = True
    for g in range(scalar):
        m[g * single_pad:(g + 1) * single_pad, (g + 1) * single_pad:pad] = True
        m[g * single_pad:(g + 1) * single_pad, :g * single_pad] = True
    return m


class MultiScaleMaskedTransformerDecoderMaskDN(nn.Module):
    # the MaskDN decoder carries the DN label embedding (unused at inference)
    has_label_enc = True
    # query embeddings x per-pixel mask embeddings -> mask logits
    mask_product = "bqc,bchw->bqhw"

    def __init__(self, in_channels: int, *, num_classes: int, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, pre_norm: bool = False, mask_dim: int = 256,
                 enforce_input_project: bool = False, num_feature_levels: int = 3,
                 all_lys: bool = False, dn_label_noise_ratio: float = -1.0,
                 dn_max_gt: int = 0):
        super().__init__()
        self.hidden_dim, self.num_classes = hidden_dim, num_classes
        self.num_queries, self.nheads = num_queries, nheads
        self.all_lys = all_lys
        self.dn_label_noise_ratio, self.dn_max_gt = dn_label_noise_ratio, dn_max_gt
        self.num_layers, self.num_feature_levels = dec_layers, num_feature_levels
        # no dropout: the JAX decoder hard-codes 0.0 here (its :281-294)
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, nheads, normalize_before=pre_norm)
            for _ in range(dec_layers))
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, nheads, normalize_before=pre_norm)
            for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim, dim_feedforward, normalize_before=pre_norm)
            for _ in range(dec_layers))
        self.decoder_norm = LayerNorm(hidden_dim)
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
        """The decoder `cfg` describes: DN_MODE points without HEAD_DN and
        LAST_Q_RATIO, where the decoder has mask-piloted queries."""
        mf = cfg.MODEL.MASK_FORMER
        if cls.has_label_enc and (mf.DN_MODE != "points" or mf.HEAD_DN or mf.LAST_Q_RATIO > 0):
            raise ValueError("the reference's MaskDN decoder runs DN_MODE points without HEAD_DN "
                             "and LAST_Q_RATIO")
        return cls(
            in_channels,
            num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
            hidden_dim=mf.HIDDEN_DIM,
            num_queries=mf.NUM_OBJECT_QUERIES,
            nheads=mf.NHEADS,
            dim_feedforward=mf.DIM_FEEDFORWARD,
            dec_layers=mf.DEC_LAYERS - 1,  # reference from_config: one is the query loss
            pre_norm=mf.PRE_NORM,
            mask_dim=cfg.MODEL.SEM_SEG_HEAD.MASK_DIM,
            enforce_input_project=mf.ENFORCE_INPUT_PROJ,
            all_lys=mf.ALL_LY_DN,
            dn_label_noise_ratio=mf.LB_NOISE_RATIO,
            dn_max_gt=cfg.TPU.DN_MAX_GT,
        )

    def forward_prediction_heads(self, output: torch.Tensor, mask_features: torch.Tensor,
                                 attn_mask_target_size):
        """(B, Q, C) queries -> class logits (B, Q, K+1), mask logits
        (B, Q, H/4, W/4) and the next attention mask (B, Q, h*w) bool,
        True = blocked, shared by the heads (reference :1859-1877)."""
        dec = self.decoder_norm(output)
        outputs_class = self.class_embed(dec)
        mask_embed = self.mask_embed(dec)
        outputs_mask = torch.einsum(self.mask_product, mask_embed, mask_features)
        # the JAX package (`mask2former_decoder.py:325-327`) resizes the mask
        # logits in their own type and thresholds the sigmoid there: in
        # bfloat16 a logit within ~0.004 below 0 rounds to a sigmoid of 0.5,
        # which does not block
        with float32_region(outputs_mask.device.type):
            attn_mask = resize(outputs_mask, attn_mask_target_size, "bilinear")
            attn_mask = attn_mask.sigmoid().flatten(2) < 0.5
        return outputs_class, outputs_mask, attn_mask

    def _prepare_dn(self, dn_args: DNArgs, size_list, generator):
        """The DN block (JAX :344-476): (content (B, pad, C), (T, T)
        self-attention mask, a function level -> the DN rows' blocked mask
        (B, pad, S_l), the meta dict the criterion reads)."""
        targets = dn_args.targets
        if 0 < self.dn_max_gt < targets.num_instances:
            targets = targets.first(self.dn_max_gt)  # valid-prefix: a cap is a slice
        N, scalar = targets.num_instances, dn_args.scalar
        B, pad_size = targets.labels.shape[0], scalar * N
        noise_scale = dn_args.noise_scale
        valid = targets.valid
        device = valid.device
        gt_masks = targets.masks.float()
        # a pixel is blocked where no part of the mask falls on it: area
        # downsampling (:986)
        blocked_lvl = []
        for h, w in size_list:
            blk = resize(gt_masks, (h, w), "area").reshape(B, N, h * w) <= 1e-8
            blocked_lvl.append(blk | ~valid[:, :, None])

        def dn_padding_mask(level: int) -> torch.Tensor:
            """reference gen_mask_dn :1584-1622: each entry flips with a
            probability proportional to the mask's area."""
            blk = blocked_lvl[level]
            s = blk.shape[-1]
            m = blk[:, None].expand(B, scalar, N, s)
            if noise_scale > 0:
                ratio = (~m).sum(-1).float() * noise_scale / s
                flip = uniform(m.shape, generator, device) < ratio[..., None]
                m = (m ^ flip) | ~valid[:, None, :, None]
            return m.reshape(B, pad_size, s)

        labels = targets.labels[:, None, :].expand(B, scalar, N)
        if self.dn_label_noise_ratio > 0:
            # class-flip noise (reference :1004-1018)
            flip = uniform(labels.shape, generator, device) < self.dn_label_noise_ratio
            rand_lb = (uniform(labels.shape, generator, device) * self.num_classes).long()
            labels = torch.where(flip, rand_lb, labels)
        labels = labels.clamp(0, self.num_classes - 1)
        content = self.label_enc(labels)
        content = (content * valid[:, None, :, None]).to(region_dtype(device.type))
        tgt_mask = _dn_tgt_mask(scalar, N, self.num_queries).to(device)
        meta = {"max_num": N, "pad_size": pad_size, "scalar": scalar}
        return content.reshape(B, pad_size, -1), tgt_mask, dn_padding_mask, meta

    def forward(self, x: List[torch.Tensor], mask_features: torch.Tensor,
                dn_args: Optional[DNArgs] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """x: the pixel decoder's [1/32, 1/16, 1/8] maps (B, C, h, w);
        mask_features (B, mask_dim, H/4, W/4). `dn_args` switches the DN
        training path on; its noise is drawn from `generator` (module
        docstring)."""
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

        # the queries enter the layers in the compute type (JAX :469-483)
        output = self.query_feat.weight[None].expand(B, -1, -1).to(region_dtype(x[0].device.type))
        use_dn = dn_args is not None and self.has_label_enc
        tgt_mask, pad_size = None, 0
        if use_dn:
            content, tgt_mask, dn_padding_mask, dn_meta = self._prepare_dn(
                dn_args, size_list, generator)
            pad_size = dn_meta["pad_size"]
            output = torch.cat([content, output], dim=1)

        outputs_class, outputs_mask, attn_mask = self.forward_prediction_heads(
            output, mask_features, size_list[0])
        if use_dn:
            attn_mask = torch.cat([dn_padding_mask(0), attn_mask[:, pad_size:]], dim=1)
        predictions_class, predictions_mask = [outputs_class], [outputs_mask]
        for i in range(self.num_layers):
            level_index = i % self.num_feature_levels
            # degenerate all-blocked rows attend everywhere (reference :1780)
            attn_mask = attn_mask & ~attn_mask.all(dim=-1, keepdim=True)
            output = self.transformer_cross_attention_layers[i](
                output, src[level_index], attn_mask, pos[level_index])
            output = self.transformer_self_attention_layers[i](output, tgt_mask)
            output = self.transformer_ffn_layers[i](output)
            level = (i + 1) % self.num_feature_levels
            outputs_class, outputs_mask, attn_mask = self.forward_prediction_heads(
                output, mask_features, size_list[level])
            # per-layer refresh of the DN rows (reference :1805-1816): in every
            # layer with ALL_LY_DN, else in the first three; elsewhere the DN
            # rows keep the predicted masks
            if use_dn and (self.all_lys or i < 3):
                attn_mask = torch.cat([dn_padding_mask(level), attn_mask[:, pad_size:]], dim=1)
            predictions_class.append(outputs_class)
            predictions_mask.append(outputs_mask)

        dn_out = None
        if use_dn:
            dn_cls = [p[:, :pad_size] for p in predictions_class]
            dn_msk = [p[:, :pad_size] for p in predictions_mask]
            predictions_class = [p[:, pad_size:] for p in predictions_class]
            predictions_mask = [p[:, pad_size:] for p in predictions_mask]
            dn_out = {"pred_logits": dn_cls[-1], "pred_masks": dn_msk[-1],
                      "aux_outputs": [{"pred_logits": a, "pred_masks": b}
                                      for a, b in zip(dn_cls[:-1], dn_msk[:-1])],
                      "dn_args": dn_meta}
        out = {
            "pred_logits": predictions_class[-1],
            "pred_masks": predictions_mask[-1],
            "aux_outputs": [{"pred_logits": a, "pred_masks": b}
                            for a, b in zip(predictions_class[:-1], predictions_mask[:-1])],
        }
        if dn_args is not None:
            out["dn_out"] = dn_out
        return out


class MultiScaleMaskedTransformerDecoder(MultiScaleMaskedTransformerDecoderMaskDN):
    """Vanilla Mask2Former decoder (reference :209-555): no DN label embedding."""

    has_label_enc = False
