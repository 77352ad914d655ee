"""MaskFormerHead: pixel decoder + transformer predictor (reference
modeling/meta_arch/mask_former_head.py:18-132,
`mp_former_tpu/models/meta_arch/mask_former_head.py`). Only the
`multi_scale_pixel_decoder` input, the released recipe's, is ported."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...structures import DNArgs
from ...utils.registry import PIXEL_DECODER_REGISTRY, SEM_SEG_HEADS_REGISTRY
from ...utils.shape_spec import ShapeSpec
from ..transformer_decoder.mask2former_decoder import build_transformer_decoder


def build_pixel_decoder(cfg, input_shape):
    """Reference pixel_decoder/fpn.py:21-33."""
    name = cfg.MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME
    return PIXEL_DECODER_REGISTRY.get(name).from_config(cfg, input_shape)


@SEM_SEG_HEADS_REGISTRY.register()
class MaskFormerHead(nn.Module):
    def __init__(self, pixel_decoder: nn.Module, predictor: nn.Module):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]):
        feature = cfg.MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE
        if feature != "multi_scale_pixel_decoder":
            raise NotImplementedError(
                f"TRANSFORMER_IN_FEATURE {feature!r}: the port has the "
                "multi_scale_pixel_decoder input only so far")
        return cls(build_pixel_decoder(cfg, input_shape),
                   build_transformer_decoder(cfg, cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM))

    def forward(self, features: Dict[str, torch.Tensor], dn_args: Optional[DNArgs] = None,
                generator: Optional[torch.Generator] = None, **predictor_kwargs) -> Dict:
        """`predictor_kwargs` go to the predictor as they are (the video
        decoder's `num_frames`)."""
        mask_features, _, multi_scale = self.pixel_decoder.forward_features(features)
        if dn_args is None:
            return self.predictor(multi_scale, mask_features, **predictor_kwargs)
        return self.predictor(multi_scale, mask_features, dn_args, generator, **predictor_kwargs)
