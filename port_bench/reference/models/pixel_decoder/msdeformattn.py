"""MSDeformAttn pixel decoder (reference pixel_decoder/msdeformattn.py:23-358,
`mp_former_tpu/models/pixel_decoder/msdeformattn.py`).

A deformable-DETR encoder over the res3-res5 features (6 layers in the
recipe) and one FPN step down to res2. Returns (mask_features at 1/4, the
encoder's 1/32 map, [1/32, 1/16, 1/8] multi-scale maps), all NCHW. Images are
unpadded, so the valid ratios are 1 and the reference points are the fixed
grid of pixel centres. `TPU.SAMPLING_ENGINE` and `TPU.PALLAS_TAP_WEIGHTING`
choose the deformable sampling engine (`ops/ms_deform_attn.py:MSDeformAttn`).
`TPU.REMAT_ENCODER` / `TPU.REMAT_POLICY` recompute the encoder layers in the
backward (`MSDeformAttnTransformerEncoderOnly`). Only the unrolled encoder is
ported: `TPU.SCAN_ENCODER` and `TPU.SHARD_TOKENS` are TPU devices.
`MODEL.MASK_FORMER.DROPOUT` is the encoder layers' dropout in training mode
(JAX `msdeformattn.py:48-61`: after the deformable attention, after the FFN's
ReLU and after its output), drawn from the generator `forward_features`
takes.

In a bfloat16 compute region (`TPU.COMPUTE_DTYPE bfloat16`) the module follows
its reference, the JAX package (`msdeformattn.py:285-332`), and departs on
purpose from upstream Mask2Former, which runs it in float32 under AMP: the
backbone's maps are rounded to bfloat16, the input projections, the FPN
convolutions and their GroupNorms run in float32 on those rounded maps (flax
promotes them), the position embeddings are bfloat16 and the encoder layers
compute in bfloat16. mask_features come out float32, the multi-scale maps
bfloat16.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from .... import flops as count
from ...ops.ms_deform_attn import MSDeformAttn
from ...utils import float32_region, region_dtype
from ...utils.layers import Conv2d, LayerNorm, apply_keep, c2_xavier_fill, keep_masks
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
    """Post-norm deformable self-attention + FFN, with dropout in training."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4, sampling_engine: str = "packed2x2",
                 pallas_weighting: bool = False, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      sampling_engine, pallas_weighting)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model)

    def keep_masks(self, src: torch.Tensor, generator) -> Optional[Tuple[torch.Tensor, ...]]:
        """The layer's three dropout masks for an input like `src` (B, S, C),
        in the JAX layer's order (attention output, ReLU, FFN output), or
        None in eval mode or without dropout."""
        if not (self.training and self.dropout > 0):
            return None
        b, n, c = src.shape
        return keep_masks([(b, n, c), (b, n, self.linear1.out_features), (b, n, c)],
                          self.dropout, generator, src.device)

    def forward(self, src, pos, reference_points, spatial_shapes, keeps=None):
        """`keeps`: the layer's `keep_masks`, or None for no dropout."""
        k_attn, k_relu, k_out = keeps if keeps is not None else (None, None, None)
        p = self.dropout
        attn = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + apply_keep(attn, k_attn, p))
        h = apply_keep(F.relu(self.linear1(src)), k_relu, p)
        return self.norm2(src + apply_keep(self.linear2(h), k_out, p))


class MSDeformAttnTransformerEncoder(nn.Module):
    def __init__(self, layers: List[MSDeformAttnTransformerEncoderLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


# what `REMAT_POLICY dots` keeps from the forward: the outputs of matrix
# products, as jax.checkpoint_policies.dots_saveable does
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


class MSDeformAttnTransformerEncoderOnly(nn.Module):
    """Reference MSDeformAttnTransformerEncoderOnly (:23-89), unrolled.

    `remat` (TPU.REMAT_ENCODER, the JAX package's `msdeformattn.py:197-205`)
    recomputes each encoder layer in the backward instead of keeping its
    activations (`torch.utils.checkpoint`, non-reentrant), wherever autograd
    records (`torch.is_grad_enabled()`, whatever the module's train/eval
    mode). `remat_policy` (TPU.REMAT_POLICY): "dots" keeps the outputs of
    matrix products and recomputes the rest (selective checkpointing, the
    JAX package's `dots_saveable`); any other value recomputes everything.
    Autocast's state is replayed in the recompute. `torch.utils.checkpoint`
    would restore the global RNG but not the explicit generator the dropout
    draws from, so each layer's dropout masks are drawn before its
    recomputed region and handed in: the recompute drops what the forward
    dropped, as flax's remat replays its dropout keys."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 6,
                 dim_feedforward: int = 1024, num_feature_levels: int = 3,
                 enc_n_points: int = 4, sampling_engine: str = "packed2x2",
                 pallas_weighting: bool = False, remat: bool = False,
                 remat_policy: str = "full", dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.remat = remat
        self.remat_policy = remat_policy
        self.encoder = MSDeformAttnTransformerEncoder([
            MSDeformAttnTransformerEncoderLayer(d_model, dim_feedforward, num_feature_levels,
                                                nhead, enc_n_points, sampling_engine,
                                                pallas_weighting, dropout)
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

    def forward(self, srcs: List[torch.Tensor], pos_embeds: List[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """srcs, pos_embeds: per-level (B, C, H, W). Returns (memory (B, S, C),
        spatial_shapes). `generator` feeds the dropout in training mode."""
        spatial_shapes = [tuple(s.shape[-2:]) for s in srcs]
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        pos_flat = torch.cat([p.flatten(2).transpose(1, 2) + self.level_embed[i][None, None]
                              for i, p in enumerate(pos_embeds)], 1)
        ref = _reference_points(spatial_shapes, src_flat.device)[None]
        ref = ref.expand(src_flat.shape[0], -1, -1, -1)
        out = src_flat
        for layer in self.encoder.layers:
            keeps = layer.keep_masks(out, generator)
            if self.remat and torch.is_grad_enabled():
                # the recompute is not counted as the step's work
                out = ckpt.checkpoint(count.once(layer), out, pos_flat, ref, spatial_shapes, keeps,
                                      use_reentrant=False, preserve_rng_state=False,
                                      **self._remat_context())
            else:
                out = layer(out, pos_flat, ref, spatial_shapes, keeps)
        return out, spatial_shapes

    def _remat_context(self) -> dict:
        if self.remat_policy != "dots":
            return {}
        if not hasattr(ckpt, "create_selective_checkpoint_contexts"):
            raise NotImplementedError(
                f"TPU.REMAT_POLICY dots needs selective activation checkpointing, which torch "
                f"{torch.__version__} lacks; set TPU.REMAT_POLICY full")
        return {"context_fn": functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                _save_dots)}


class MSDeformAttnPixelDecoder(nn.Module):
    """Reference MSDeformAttnPixelDecoder (:164-358), NCHW in and out."""

    def __init__(self, input_shape: Dict[str, ShapeSpec], *, transformer_nheads: int = 8,
                 transformer_dim_feedforward: int = 1024, transformer_enc_layers: int = 6,
                 conv_dim: int = 256, mask_dim: int = 256, norm: str = "GN",
                 transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
                 common_stride: int = 4, maskformer_num_feature_levels: int = 3,
                 sampling_engine: str = "packed2x2", pallas_weighting: bool = False,
                 remat: bool = False, remat_policy: str = "full", transformer_dropout: float = 0.0):
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
            sampling_engine=sampling_engine, pallas_weighting=pallas_weighting,
            remat=remat, remat_policy=remat_policy, dropout=transformer_dropout)
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
            remat=cfg.TPU.REMAT_ENCODER,
            remat_policy=cfg.TPU.REMAT_POLICY,
            transformer_dropout=cfg.MODEL.MASK_FORMER.DROPOUT,
        )

    def forward_features(self, features: Dict[str, torch.Tensor],
                         generator: Optional[torch.Generator] = None):
        device_type = next(iter(features.values())).device.type
        dtype = region_dtype(device_type)
        srcs, pos = [], []
        for idx, f in enumerate(self.transformer_in_features):
            x = features[f].to(dtype)
            with float32_region(device_type):
                srcs.append(self.input_proj[idx](x.float()))
            h, w = x.shape[-2:]
            pe = position_embedding_sine(h, w, self.conv_dim // 2, device=x.device, dtype=dtype)
            pos.append(pe.permute(2, 0, 1)[None].expand(x.shape[0], -1, -1, -1))
        memory, spatial_shapes = self.transformer(srcs, pos, generator)
        out, start = [], 0
        B = memory.shape[0]
        for h, w in spatial_shapes:
            out.append(memory[:, start:start + h * w].transpose(1, 2).reshape(B, self.conv_dim, h, w))
            start += h * w
        with float32_region(device_type):
            for idx, f in enumerate(self.fpn_features):
                x = features[f].to(dtype)
                lateral = getattr(self, f"adapter_{idx + 1}")(x.float())
                y = lateral + F.interpolate(out[-1], size=x.shape[-2:], mode="bilinear",
                                            align_corners=False)
                out.append(getattr(self, f"layer_{idx + 1}")(y))
            mask_features = self.mask_features(out[-1])
        return mask_features, out[0], out[:self.maskformer_num_feature_levels]
