"""VideoMultiScaleMaskedTransformerDecoder (reference
mask2former_video/modeling/transformer_decoder/video_mask2former_transformer_decoder.py,
`mp_former_tpu/video/video_decoder.py:50-187`).

The image decoder extended with time. The pixel decoder's maps of the T
frames of a clip become one (T*h*w)-token sequence per level, with the 2-D
sine embedding of each frame plus a temporal term shared by the levels
(reference PositionEmbeddingSine3D); the mask head is einsum
"bqc,btchw->bqthw"; the learnable `query_embed` is kept and added to the
queries of both attentions (reference :323). The attention mask of a layer is
the bilinear resize of the (B, Q, T, H/4, W/4) mask logits to the level,
sigmoid < 0.5, one (B, Q, T*h*w) mask shared by the heads: on CUDA K3 runs
over the keys of all T frames (`primitives.CrossAttentionLayer`). A row
blocked everywhere attends everywhere. No DN queries: the reference's video
stack has none.

A clip runs at its own length: `forward(..., num_frames=T)`, T from the
frames the meta-architecture was given (`INPUT.SAMPLING_FRAME_NUM` where no
length is passed). The JAX package pads clips to a static length bucket and
blocks the padding frames (`frame_valid`), because each length compiles once
under jit; PyTorch runs eagerly, so the port carries no padding and no
`frame_valid`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ...utils import region_dtype
from ...utils.registry import TRANSFORMER_DECODER_REGISTRY
from .mask2former_decoder import MultiScaleMaskedTransformerDecoder
from .position_encoding import position_embedding_sine


def _temporal_pos(b: int, t: int, c: int, device: Optional[torch.device] = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, T, C) temporal term of the reference's PositionEmbeddingSine3D
    (video position_encoding.py:35-57) for T frames: the frame index 1..T
    normalised by T to (0, 2 pi], swept over a C-wide frequency ladder, sin
    and cos interleaved (JAX `video_decoder.py:_temporal_pos` with every frame
    valid)."""
    z = torch.arange(1, t + 1, dtype=torch.float32, device=device)
    z = z / (t + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(c, dtype=torch.float32, device=device)
    dim_t = 10000 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / c)
    pz = z[:, None] / dim_t
    pz = torch.stack((pz[:, 0::2].sin(), pz[:, 1::2].cos()), dim=2).flatten(1)
    return pz.to(dtype)[None].expand(b, t, c)


@TRANSFORMER_DECODER_REGISTRY.register()
class VideoMultiScaleMaskedTransformerDecoder(MultiScaleMaskedTransformerDecoder):
    """The vanilla decoder's modules and names (`sem_seg_head.predictor.*`)
    plus `query_embed`."""

    mask_product = "bqc,btchw->bqthw"

    def __init__(self, in_channels: int, *, num_frames: int = 2, **kwargs):
        super().__init__(in_channels, **kwargs)
        self.num_frames = num_frames
        self.query_embed = nn.Embedding(self.num_queries, self.hidden_dim)

    @classmethod
    def from_config(cls, cfg, in_channels):
        return super().from_config(cfg, in_channels, num_frames=cfg.INPUT.SAMPLING_FRAME_NUM)

    def forward(self, x: List[torch.Tensor], mask_features: torch.Tensor,
                num_frames: Optional[int] = None) -> Dict:
        """x: the pixel decoder's [1/32, 1/16, 1/8] maps of B clips of T
        frames, (B*T, C, h, w), frame-major within a clip; mask_features
        (B*T, mask_dim, H/4, W/4). Returns `pred_logits` (B, Q, K+1),
        `pred_masks` (B, Q, T, H/4, W/4) and `aux_outputs`."""
        t = self.num_frames if num_frames is None else num_frames
        if len(x) != self.num_feature_levels:
            raise ValueError(f"expected {self.num_feature_levels} levels, got {len(x)}")
        if x[0].shape[0] % t:
            raise ValueError(f"{x[0].shape[0]} frames are not whole clips of {t}")
        b, C = x[0].shape[0] // t, self.hidden_dim
        pos_z = _temporal_pos(b, t, C, device=x[0].device, dtype=x[0].dtype)
        src, pos, size_list = [], [], []
        for i, xi in enumerate(x):
            h, w = xi.shape[-2:]
            size_list.append((h, w))
            pe = position_embedding_sine(h, w, C // 2, device=xi.device, dtype=xi.dtype)
            pos.append((pe.reshape(1, 1, h * w, C) + pos_z[:, :, None]).reshape(b, t * h * w, C))
            s = self.input_proj[i](xi).flatten(2).transpose(1, 2).reshape(b, t * h * w, C)
            src.append(s + self.level_embed.weight[i][None, None])
        mask_features = mask_features.reshape(b, t, *mask_features.shape[1:])

        dtype = region_dtype(x[0].device.type)
        query_pos = self.query_embed.weight[None].expand(b, -1, -1).to(dtype)
        output = self.query_feat.weight[None].expand(b, -1, -1).to(dtype)
        outputs_class, outputs_mask, attn_mask = self.forward_prediction_heads(
            output, mask_features, size_list[0])
        predictions_class, predictions_mask = [outputs_class], [outputs_mask]
        for i in range(self.num_layers):
            level_index = i % self.num_feature_levels
            # degenerate all-blocked rows attend everywhere (reference :159-160)
            attn_mask = attn_mask & ~attn_mask.all(dim=-1, keepdim=True)
            output = self.transformer_cross_attention_layers[i](
                output, src[level_index], attn_mask, pos[level_index], query_pos)
            output = self.transformer_self_attention_layers[i](output, None, query_pos)
            output = self.transformer_ffn_layers[i](output)
            outputs_class, outputs_mask, attn_mask = self.forward_prediction_heads(
                output, mask_features, size_list[(i + 1) % self.num_feature_levels])
            predictions_class.append(outputs_class)
            predictions_mask.append(outputs_mask)
        return {
            "pred_logits": predictions_class[-1],
            "pred_masks": predictions_mask[-1],
            "aux_outputs": [{"pred_logits": a, "pred_masks": m}
                            for a, m in zip(predictions_class[:-1], predictions_mask[:-1])],
        }
