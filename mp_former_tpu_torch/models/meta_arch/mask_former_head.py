"""MaskFormerHead: pixel decoder + transformer predictor (reference
modeling/meta_arch/mask_former_head.py:18-132,
`mp_former_tpu/models/meta_arch/mask_former_head.py`).

`TRANSFORMER_IN_FEATURE` picks what the predictor reads (JAX :33-41, :60-72):
the pixel decoder's multi-scale maps (`multi_scale_pixel_decoder`, the
Mask2Former decoders'), its transformer encoder's map (`transformer_encoder`,
`TransformerEncoderPixelDecoder`'s), its mask features (`pixel_embedding`), or
a backbone feature by name (`res5`, MaskFormer-v1's)."""

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


def predictor_in_channels(cfg, input_shape: Dict[str, ShapeSpec]) -> int:
    """The channels of what TRANSFORMER_IN_FEATURE hands the predictor."""
    feature = cfg.MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE
    if feature in ("transformer_encoder", "multi_scale_pixel_decoder"):
        return cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM
    if feature == "pixel_embedding":
        return cfg.MODEL.SEM_SEG_HEAD.MASK_DIM
    if feature not in input_shape:
        raise ValueError(f"TRANSFORMER_IN_FEATURE {feature!r} is no backbone feature "
                         f"({sorted(input_shape)}) and none of transformer_encoder, "
                         "pixel_embedding, multi_scale_pixel_decoder")
    return input_shape[feature].channels


@SEM_SEG_HEADS_REGISTRY.register()
class MaskFormerHead(nn.Module):
    def __init__(self, pixel_decoder: nn.Module, predictor: nn.Module,
                 transformer_in_feature: str = "multi_scale_pixel_decoder"):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor
        self.transformer_in_feature = transformer_in_feature

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]):
        return cls(build_pixel_decoder(cfg, input_shape),
                   build_transformer_decoder(cfg, predictor_in_channels(cfg, input_shape)),
                   cfg.MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE)

    def forward(self, features: Dict[str, torch.Tensor], dn_args: Optional[DNArgs] = None,
                generator: Optional[torch.Generator] = None, **predictor_kwargs) -> Dict:
        """`generator` feeds the pixel decoder's dropout and, in training
        (`dn_args`), the predictor's draws; `predictor_kwargs` go to the
        predictor as they are (the video decoder's `num_frames`)."""
        mask_features, tx_features, multi_scale = self.pixel_decoder.forward_features(
            features, generator)
        feature = self.transformer_in_feature
        if feature == "multi_scale_pixel_decoder":
            x = multi_scale
        elif feature == "transformer_encoder":
            if tx_features is None:
                raise ValueError("TRANSFORMER_IN_FEATURE transformer_encoder: the pixel decoder "
                                 f"{type(self.pixel_decoder).__name__} has no transformer encoder")
            x = [tx_features]
        elif feature == "pixel_embedding":
            x = [mask_features]
        else:
            x = [features[feature]]
        if dn_args is None:
            return self.predictor(x, mask_features, **predictor_kwargs)
        return self.predictor(x, mask_features, dn_args, generator, **predictor_kwargs)
