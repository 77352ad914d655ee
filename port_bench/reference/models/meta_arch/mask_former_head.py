"""MaskFormerHead: pixel decoder + transformer predictor (reference
modeling/meta_arch/mask_former_head.py:18-132,
`mp_former_tpu/models/meta_arch/mask_former_head.py`).

The predictor reads the pixel decoder's multi-scale maps
(`TRANSFORMER_IN_FEATURE multi_scale_pixel_decoder`, the Mask2Former
decoders'; JAX :33-41, :60-72)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...structures import DNArgs
from ...utils.shape_spec import ShapeSpec
from ..pixel_decoder.msdeformattn import MSDeformAttnPixelDecoder
from ..transformer_decoder.mask2former_decoder import build_transformer_decoder


class MaskFormerHead(nn.Module):
    def __init__(self, pixel_decoder: nn.Module, predictor: nn.Module):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]):
        if cfg.MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME != "MSDeformAttnPixelDecoder" or \
                cfg.MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE != "multi_scale_pixel_decoder":
            raise ValueError("the reference's head is MSDeformAttnPixelDecoder's multi-scale maps")
        return cls(MSDeformAttnPixelDecoder.from_config(cfg, input_shape),
                   build_transformer_decoder(cfg, cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM))

    def forward(self, features: Dict[str, torch.Tensor], dn_args: Optional[DNArgs] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """`generator` feeds the pixel decoder's dropout and, in training
        (`dn_args`), the predictor's draws."""
        mask_features, _, multi_scale = self.pixel_decoder.forward_features(features, generator)
        if dn_args is None:
            return self.predictor(multi_scale, mask_features)
        return self.predictor(multi_scale, mask_features, dn_args, generator)
