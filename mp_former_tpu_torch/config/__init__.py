from .cfg import CfgNode
from .build import build_cfg, cfg_device
from .defaults import (
    get_cfg,
    add_deeplab_config,
    add_maskformer2_config,
    add_maskformer2_video_config,
)

__all__ = [
    "CfgNode",
    "get_cfg",
    "add_deeplab_config",
    "add_maskformer2_config",
    "add_maskformer2_video_config",
    "build_cfg",
    "cfg_device",
]
