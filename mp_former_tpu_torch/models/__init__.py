"""Model components. Importing this package registers every ported component
(`mp_former_tpu/models/__init__.py`)."""

from .backbone import resnet, swin  # noqa: F401
from .pixel_decoder import fpn, msdeformattn  # noqa: F401
from .transformer_decoder import (mask2former_decoder, maskformer_transformer_decoder,  # noqa: F401
                                  video_decoder)
from .meta_arch import mask_former_head, maskformer, per_pixel_baseline, video_maskformer  # noqa: F401

from ..utils.registry import META_ARCH_REGISTRY


def build_model(cfg):
    """Registry-driven model construction (d2 build_model equivalent), in
    `.eval()` mode. Training is selected by passing targets to its forward;
    the model's `.train()` mode switches on the dropout of
    MODEL.MASK_FORMER.DROPOUT (`Trainer` sets it, the evaluation loops and
    `Predictor` set `.eval()`)."""
    return META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE).from_config(cfg).eval()
