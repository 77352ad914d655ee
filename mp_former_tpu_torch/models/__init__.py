"""Model components. Importing this package registers every ported component
(`mp_former_tpu/models/__init__.py`)."""

from .backbone import resnet, swin  # noqa: F401
from .pixel_decoder import msdeformattn  # noqa: F401
from .transformer_decoder import mask2former_decoder  # noqa: F401
from .meta_arch import mask_former_head, maskformer  # noqa: F401

from ..utils.registry import META_ARCH_REGISTRY


def build_model(cfg):
    """Registry-driven model construction (d2 build_model equivalent). The
    model has no layer that behaves differently in training (FrozenBN, no
    dropout): training is selected by passing targets to its forward."""
    return META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE).from_config(cfg).eval()
