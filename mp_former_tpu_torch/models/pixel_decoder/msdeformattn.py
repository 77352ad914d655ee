"""MSDeformAttn pixel decoder (reference pixel_decoder/msdeformattn.py:23-358,
`mp_former_tpu/models/pixel_decoder/msdeformattn.py`).

A deformable-DETR encoder over the res3-res5 features (6 layers in the
recipe) and one FPN step down to res2. Returns (mask_features at 1/4, the
encoder's 1/32 map, [1/32, 1/16, 1/8] multi-scale maps), all NCHW. Images are
unpadded, so the valid ratios are 1 and the reference points are the fixed
grid of pixel centres. `TPU.SAMPLING_ENGINE` and `TPU.PALLAS_TAP_WEIGHTING`
choose the deformable sampling engine (`ops/ms_deform_attn.py:MSDeformAttn`).
Only the unrolled encoder is ported: `TPU.SCAN_ENCODER`, `TPU.SHARD_TOKENS` and
remat are TPU devices.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.ms_deform_attn import MSDeformAttn
from ...utils.layers import Conv2d, c2_xavier_fill
from ...utils.registry import PIXEL_DECODER_REGISTRY
from ...utils.shape_spec import ShapeSpec
from ..transformer_decoder.position_encoding import position_embedding_sine


def _reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                      device=None) -> torch.Tensor:
    """(S, L, 2) normalised pixel-centre grid, (x, y), valid ratios 1."""
    pts = []
    for h, w in spatial_shapes:
        ry = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        rx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(pts, 0)
    return ref[:, None, :].expand(-1, len(spatial_shapes), -1)


class MSDeformAttnTransformerEncoderLayer(nn.Module):
    """Post-norm deformable self-attention + FFN (dropout is 0 at eval)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4, sampling_engine: str = "packed2x2",
                 pallas_weighting: bool = False):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      sampling_engine, pallas_weighting)
        self.norm1 = nn.LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, src, pos, reference_points, spatial_shapes):
        src = self.norm1(src + self.self_attn(src + pos, reference_points, src, spatial_shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class MSDeformAttnTransformerEncoder(nn.Module):
    def __init__(self, layers: List[MSDeformAttnTransformerEncoderLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class MSDeformAttnTransformerEncoderOnly(nn.Module):
    """Reference MSDeformAttnTransformerEncoderOnly (:23-89), unrolled."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 6,
                 dim_feedforward: int = 1024, num_feature_levels: int = 3,
                 enc_n_points: int = 4, sampling_engine: str = "packed2x2",
                 pallas_weighting: bool = False):
        super().__init__()
        self.d_model = d_model
        self.encoder = MSDeformAttnTransformerEncoder([
            MSDeformAttnTransformerEncoderLayer(d_model, dim_feedforward, num_feature_levels,
                                                nhead, enc_n_points, sampling_engine,
                                                pallas_weighting)
            for _ in range(num_encoder_layers)])
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, d_model))
        # reference _reset_parameters: xavier on every matrix, then the
        # deformable-attention inits, normal level embeds
        for p in self.parameters():
            if p.dim() > 1:
                nn.init.xavier_uniform_(p)
        for m in self.modules():
            if isinstance(m, MSDeformAttn):
                m._reset_parameters()
        nn.init.normal_(self.level_embed)

    def forward(self, srcs: List[torch.Tensor], pos_embeds: List[torch.Tensor]):
        """srcs, pos_embeds: per-level (B, C, H, W). Returns (memory (B, S, C),
        spatial_shapes)."""
        spatial_shapes = [tuple(s.shape[-2:]) for s in srcs]
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        pos_flat = torch.cat([p.flatten(2).transpose(1, 2) + self.level_embed[i][None, None]
                              for i, p in enumerate(pos_embeds)], 1)
        ref = _reference_points(spatial_shapes, src_flat.device)[None]
        ref = ref.expand(src_flat.shape[0], -1, -1, -1)
        out = src_flat
        for layer in self.encoder.layers:
            out = layer(out, pos_flat, ref, spatial_shapes)
        return out, spatial_shapes


@PIXEL_DECODER_REGISTRY.register()
class MSDeformAttnPixelDecoder(nn.Module):
    """Reference MSDeformAttnPixelDecoder (:164-358), NCHW in and out."""

    def __init__(self, input_shape: Dict[str, ShapeSpec], *, transformer_nheads: int = 8,
                 transformer_dim_feedforward: int = 1024, transformer_enc_layers: int = 6,
                 conv_dim: int = 256, mask_dim: int = 256, norm: str = "GN",
                 transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
                 common_stride: int = 4, maskformer_num_feature_levels: int = 3,
                 sampling_engine: str = "packed2x2", pallas_weighting: bool = False):
        super().__init__()
        self.conv_dim = conv_dim
        self.in_features = sorted(input_shape, key=lambda k: input_shape[k].stride)
        # low resolution first: res5, res4, res3 (reference :282-284)
        self.transformer_in_features = sorted(
            transformer_in_features, key=lambda k: input_shape[k].stride)[::-1]
        self.input_proj = nn.ModuleList()
        for f in self.transformer_in_features:
            conv = nn.Conv2d(input_shape[f].channels, conv_dim, kernel_size=1)
            nn.init.xavier_uniform_(conv.weight, gain=1)
            nn.init.zeros_(conv.bias)
            self.input_proj.append(nn.Sequential(conv, nn.GroupNorm(32, conv_dim)))
        self.transformer = MSDeformAttnTransformerEncoderOnly(
            d_model=conv_dim, nhead=transformer_nheads,
            num_encoder_layers=transformer_enc_layers,
            dim_feedforward=transformer_dim_feedforward,
            num_feature_levels=len(self.transformer_in_features),
            sampling_engine=sampling_engine, pallas_weighting=pallas_weighting)
        self.mask_features = Conv2d(conv_dim, mask_dim, kernel_size=1)
        c2_xavier_fill(self.mask_features)
        self.maskformer_num_feature_levels = maskformer_num_feature_levels
        stride = min(input_shape[f].stride for f in self.transformer_in_features)
        self.num_fpn_levels = int(math.log2(stride) - math.log2(common_stride))
        use_bias = norm == ""
        if norm not in ("", "GN"):
            raise NotImplementedError(f"pixel decoder norm {norm!r}: only GN or none")
        self.fpn_features = self.in_features[:self.num_fpn_levels][::-1]
        for idx, f in enumerate(self.fpn_features):
            lateral = Conv2d(input_shape[f].channels, conv_dim, kernel_size=1, bias=use_bias,
                             norm=None if use_bias else nn.GroupNorm(32, conv_dim))
            output = Conv2d(conv_dim, conv_dim, kernel_size=3, padding=1, bias=use_bias,
                            norm=None if use_bias else nn.GroupNorm(32, conv_dim),
                            activation=F.relu)
            c2_xavier_fill(lateral)
            c2_xavier_fill(output)
            self.add_module(f"adapter_{idx + 1}", lateral)
            self.add_module(f"layer_{idx + 1}", output)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]):
        head = cfg.MODEL.SEM_SEG_HEAD
        return cls(
            {k: v for k, v in input_shape.items() if k in head.IN_FEATURES},
            transformer_nheads=cfg.MODEL.MASK_FORMER.NHEADS,
            transformer_dim_feedforward=1024,  # hard-coded in reference from_config :306
            transformer_enc_layers=head.TRANSFORMER_ENC_LAYERS,
            conv_dim=head.CONVS_DIM,
            mask_dim=head.MASK_DIM,
            norm=head.NORM,
            transformer_in_features=tuple(head.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES),
            common_stride=head.COMMON_STRIDE,
            sampling_engine=cfg.TPU.SAMPLING_ENGINE,
            pallas_weighting=cfg.TPU.PALLAS_TAP_WEIGHTING,
        )

    def forward_features(self, features: Dict[str, torch.Tensor]):
        srcs, pos = [], []
        for idx, f in enumerate(self.transformer_in_features):
            x = features[f].float()  # the reference pins this module to fp32
            srcs.append(self.input_proj[idx](x))
            h, w = x.shape[-2:]
            pe = position_embedding_sine(h, w, self.conv_dim // 2, device=x.device)
            pos.append(pe.permute(2, 0, 1)[None].expand(x.shape[0], -1, -1, -1))
        memory, spatial_shapes = self.transformer(srcs, pos)
        out, start = [], 0
        B = memory.shape[0]
        for h, w in spatial_shapes:
            out.append(memory[:, start:start + h * w].transpose(1, 2).reshape(B, self.conv_dim, h, w))
            start += h * w
        for idx, f in enumerate(self.fpn_features):
            x = features[f].float()
            lateral = getattr(self, f"adapter_{idx + 1}")(x)
            y = lateral + F.interpolate(out[-1], size=x.shape[-2:], mode="bilinear",
                                        align_corners=False)
            out.append(getattr(self, f"layer_{idx + 1}")(y))
        return self.mask_features(out[-1]), out[0], out[:self.maskformer_num_feature_levels]
