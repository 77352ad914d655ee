"""The per-pixel baselines of the MaskFormer paper (reference
modeling/meta_arch/per_pixel_baseline.py:18-243,
`mp_former_tpu/models/meta_arch/per_pixel_baseline.py`): registered, used by
no recipe.

`PerPixelBaselineHead`: the pixel decoder's mask features -> a 1x1 conv to
per-pixel class logits at 1/4, bilinearly upsampled by the common stride.
`PerPixelBaselinePlusHead`: a `StandardTransformerDecoder` (at its default
widths, as the JAX head builds it) on `TRANSFORMER_IN_FEATURE`, whose
per-query class probabilities and mask sigmoids combine into per-pixel
scores, log(sum_q p(k|q) sigmoid(m_q)) clamped at 1e-8, upsampled likewise.
Both return `sem_seg_logits` (B, K, H, W) (the JAX package's are
channels-last). `per_pixel_ce_loss` is their cross-entropy. As in the JAX
package, no trainer step and no inference post-processing reads them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.interp import resize
from ...utils.layers import Conv2d
from ...utils.registry import SEM_SEG_HEADS_REGISTRY
from ...utils.shape_spec import ShapeSpec
from ..transformer_decoder.maskformer_transformer_decoder import StandardTransformerDecoder
from .mask_former_head import build_pixel_decoder


def per_pixel_ce_loss(logits: torch.Tensor, sem_seg: torch.Tensor,
                      ignore_value: int = 255) -> torch.Tensor:
    """logits (B, K, H, W), sem_seg (B, H, W) integer with `ignore_value`:
    the mean float32 cross-entropy over the pixels not ignored (0 where all
    are)."""
    valid = sem_seg != ignore_value
    nll = F.cross_entropy(logits.float(), torch.where(valid, sem_seg, 0).long(),
                          reduction="none")
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def _upsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    return resize(x, (x.shape[-2] * stride, x.shape[-1] * stride), "bilinear")


@SEM_SEG_HEADS_REGISTRY.register()
class PerPixelBaselineHead(nn.Module):
    def __init__(self, pixel_decoder: nn.Module, num_classes: int, mask_dim: int,
                 common_stride: int = 4):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.common_stride = common_stride
        self.predictor = Conv2d(mask_dim, num_classes, kernel_size=1)
        nn.init.kaiming_normal_(self.predictor.weight, mode="fan_out", nonlinearity="relu")
        nn.init.zeros_(self.predictor.bias)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]):
        head = cfg.MODEL.SEM_SEG_HEAD
        return cls(build_pixel_decoder(cfg, input_shape), head.NUM_CLASSES, head.MASK_DIM)

    def forward(self, features: Dict[str, torch.Tensor], dn_args=None,
                generator: Optional[torch.Generator] = None) -> Dict:
        mask_features, _, _ = self.pixel_decoder.forward_features(features, generator)
        return {"sem_seg_logits": _upsample(self.predictor(mask_features), self.common_stride)}


@SEM_SEG_HEADS_REGISTRY.register()
class PerPixelBaselinePlusHead(nn.Module):
    """The baseline with a transformer predictor's supervision (reference
    :127-243); the dict also carries the predictor's outputs."""

    def __init__(self, pixel_decoder: nn.Module, num_classes: int, mask_dim: int,
                 in_channels: int, transformer_in_feature: str = "res5",
                 deep_supervision: bool = True, common_stride: int = 4):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.transformer_in_feature = transformer_in_feature
        self.common_stride = common_stride
        self.predictor = StandardTransformerDecoder(
            in_channels, num_classes=num_classes, mask_dim=mask_dim,
            deep_supervision=deep_supervision)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]):
        feature = cfg.MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE
        head = cfg.MODEL.SEM_SEG_HEAD
        return cls(build_pixel_decoder(cfg, input_shape), head.NUM_CLASSES, head.MASK_DIM,
                   input_shape[feature].channels, feature, cfg.MODEL.MASK_FORMER.DEEP_SUPERVISION)

    def forward(self, features: Dict[str, torch.Tensor], dn_args=None,
                generator: Optional[torch.Generator] = None) -> Dict:
        mask_features, _, _ = self.pixel_decoder.forward_features(features, generator)
        out = self.predictor([features[self.transformer_in_feature]], mask_features,
                             generator=generator)
        probs = out["pred_logits"].softmax(-1)[..., :-1]
        sem = torch.einsum("bqk,bqhw->bkhw", probs, out["pred_masks"].sigmoid())
        out["sem_seg_logits"] = _upsample(sem.clamp(min=1e-8).log(), self.common_stride)
        return out
