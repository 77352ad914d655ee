"""FPN pixel decoders of MaskFormer-v1 (reference pixel_decoder/fpn.py:37-312,
`mp_former_tpu/models/pixel_decoder/fpn.py`).

`BasePixelDecoder`: a 3x3 conv on the lowest-resolution feature, then top-down
over the others a 1x1 lateral conv plus the nearest-upsampled map above it,
each followed by a 3x3 conv (GroupNorm and ReLU where `norm` is GN), and a
3x3 `mask_features` conv at the highest resolution. `forward_features`
returns (mask_features, the transformer encoder's map or None, the first
MASKFORMER_NUM_FEATURE_LEVELS maps from the top), NCHW.
`TransformerEncoderPixelDecoder` runs a DETR encoder (`TRANSFORMER_ENC_LAYERS`
post- or pre-norm layers, without the reference's final norm under pre-norm,
as in the JAX package) over the 1x1 projection of the top feature first, and
returns its map as the transformer feature. Its LayerNorms take flax's
default eps, 1e-6, as the JAX package's (the reference's take torch's 1e-5).
Plain torch ops: the JAX package runs these through XLA, without a kernel.
Module names are the reference's
(`adapter_{k}`, `layer_{k}` numbered from res2, `mask_features`,
`input_proj`, `transformer.encoder.layers.{i}`), so a MaskFormer-v1 `.pth`
loads directly.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.layers import Conv2d, LayerNorm, c2_xavier_fill, dropout as drop
from ...utils.registry import PIXEL_DECODER_REGISTRY
from ...utils.shape_spec import ShapeSpec
from ..transformer_decoder.position_encoding import position_embedding_sine
from ..transformer_decoder.primitives import MultiheadAttention

# flax's LayerNorm default, which the JAX package's v1 modules keep
FLAX_LN_EPS = 1e-6


def _conv(in_ch: int, out_ch: int, kernel: int, norm: str, relu: bool) -> Conv2d:
    """detectron2's Conv2d with GN (no bias) or a bias, c2 xavier init."""
    if norm not in ("", "GN"):
        raise NotImplementedError(f"pixel decoder norm {norm!r}: only GN or none")
    conv = Conv2d(in_ch, out_ch, kernel_size=kernel, padding=(kernel - 1) // 2,
                  bias=norm == "", norm=nn.GroupNorm(32, out_ch) if norm == "GN" else None,
                  activation=F.relu if relu else None)
    c2_xavier_fill(conv)
    return conv


class TransformerEncoderLayer(nn.Module):
    """DETR's encoder layer (JAX `fpn.py:TransformerEncoderLayerVanilla`):
    self-attention with the position added to queries and keys, then a ReLU
    FFN; dropout on the attention weights and on each sublayer, in training."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, normalize_before: bool = False):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, fused=False, dropout=dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.norm2 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.dropout, self.normalize_before = dropout, normalize_before

    def forward(self, src, pos, generator: Optional[torch.Generator] = None):
        p, train = self.dropout, self.training

        def attend(x):
            return drop(self.self_attn(x + pos, x + pos, x, generator=generator), p, train,
                        generator)

        def ffn(x):
            h = drop(F.relu(self.linear1(x)), p, train, generator)
            return drop(self.linear2(h), p, train, generator)

        if self.normalize_before:
            src = src + attend(self.norm1(src))
            return src + ffn(self.norm2(src))
        src = self.norm1(src + attend(src))
        return self.norm2(src + ffn(src))


class TransformerEncoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, src, pos, generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            src = layer(src, pos, generator)
        return src


class TransformerEncoderOnly(nn.Module):
    """The reference's `transformer.encoder` container, for its names."""

    def __init__(self, encoder: TransformerEncoder):
        super().__init__()
        self.encoder = encoder


def build_encoder(d_model: int, nhead: int, dim_feedforward: int, dropout: float,
                  normalize_before: bool, num_layers: int) -> TransformerEncoder:
    """`num_layers` encoder layers, xavier-initialised as DETR's
    `_reset_parameters`."""
    enc = TransformerEncoder([TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                                      normalize_before)
                              for _ in range(num_layers)])
    for p in enc.parameters():
        if p.dim() > 1:
            nn.init.xavier_uniform_(p)
    return enc


@PIXEL_DECODER_REGISTRY.register()
class BasePixelDecoder(nn.Module):
    def __init__(self, input_shape: Dict[str, ShapeSpec], *, conv_dim: int = 256,
                 mask_dim: int = 256, norm: str = "GN", maskformer_num_feature_levels: int = 3):
        super().__init__()
        self.in_features = sorted(input_shape, key=lambda k: input_shape[k].stride)
        self.conv_dim, self.mask_dim = conv_dim, mask_dim
        self.maskformer_num_feature_levels = maskformer_num_feature_levels
        top = len(self.in_features)
        for idx, f in enumerate(self.in_features):
            ch = input_shape[f].channels
            if idx == top - 1:
                self.add_module(f"layer_{top}", self._top_conv(ch, conv_dim, norm))
            else:
                self.add_module(f"adapter_{idx + 1}", _conv(ch, conv_dim, 1, norm, relu=False))
                self.add_module(f"layer_{idx + 1}", _conv(conv_dim, conv_dim, 3, norm, relu=True))
        self.mask_features = Conv2d(conv_dim, mask_dim, kernel_size=3, padding=1)
        c2_xavier_fill(self.mask_features)

    def _top_conv(self, in_ch: int, conv_dim: int, norm: str) -> Conv2d:
        return _conv(in_ch, conv_dim, 3, norm, relu=True)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec], **extra):
        head = cfg.MODEL.SEM_SEG_HEAD
        return cls({k: v for k, v in input_shape.items() if k in head.IN_FEATURES},
                   conv_dim=head.CONVS_DIM, mask_dim=head.MASK_DIM, norm=head.NORM, **extra)

    def _top_block(self, x: torch.Tensor, generator):
        """The lowest-resolution feature -> (its map, the transformer feature)."""
        return getattr(self, f"layer_{len(self.in_features)}")(x), None

    def forward_features(self, features: Dict[str, torch.Tensor],
                         generator: Optional[torch.Generator] = None):
        multi_scale, y, tx = [], None, None
        for i, f in enumerate(self.in_features[::-1]):
            idx = len(self.in_features) - i
            x = features[f]
            if i == 0:
                y, tx = self._top_block(x, generator)
            else:
                lateral = getattr(self, f"adapter_{idx}")(x)
                y = lateral + F.interpolate(y, size=lateral.shape[-2:], mode="nearest")
                y = getattr(self, f"layer_{idx}")(y)
            if len(multi_scale) < self.maskformer_num_feature_levels:
                multi_scale.append(y)
        return self.mask_features(y), tx, multi_scale


@PIXEL_DECODER_REGISTRY.register()
class TransformerEncoderPixelDecoder(BasePixelDecoder):
    def __init__(self, input_shape: Dict[str, ShapeSpec], *, transformer_dropout: float = 0.1,
                 transformer_nheads: int = 8, transformer_dim_feedforward: int = 2048,
                 transformer_enc_layers: int = 6, transformer_pre_norm: bool = False, **kwargs):
        super().__init__(input_shape, **kwargs)
        top = input_shape[self.in_features[-1]].channels
        self.input_proj = Conv2d(top, self.conv_dim, kernel_size=1)
        c2_xavier_fill(self.input_proj)
        self.transformer = TransformerEncoderOnly(build_encoder(
            self.conv_dim, transformer_nheads, transformer_dim_feedforward, transformer_dropout,
            transformer_pre_norm, transformer_enc_layers))

    def _top_conv(self, in_ch: int, conv_dim: int, norm: str) -> Conv2d:
        # the output conv after the encoder reads its conv_dim channels
        return _conv(conv_dim, conv_dim, 3, norm, relu=True)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]):
        mf = cfg.MODEL.MASK_FORMER
        return super().from_config(
            cfg, input_shape, transformer_dropout=mf.DROPOUT, transformer_nheads=mf.NHEADS,
            transformer_dim_feedforward=mf.DIM_FEEDFORWARD,
            transformer_enc_layers=cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS,
            transformer_pre_norm=mf.PRE_NORM)

    def _top_block(self, x: torch.Tensor, generator):
        proj = self.input_proj(x)
        b, c, h, w = proj.shape
        pos = position_embedding_sine(h, w, c // 2, device=x.device,
                                      dtype=proj.dtype).reshape(1, h * w, c)
        src = self.transformer.encoder(proj.flatten(2).transpose(1, 2), pos, generator)
        tx = src.transpose(1, 2).reshape(b, c, h, w)
        return getattr(self, f"layer_{len(self.in_features)}")(tx), tx
