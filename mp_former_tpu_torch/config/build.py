"""The config and the device of an entry point: what `train_net`,
`train_net_video`, the demos and `predict` share."""

from __future__ import annotations

from typing import Sequence

from .defaults import (add_deeplab_config, add_maskformer2_config,
                       add_maskformer2_video_config, get_cfg)


def build_cfg(config_file: str, opts: Sequence[str], video: bool = False):
    """get_cfg + the DeepLab and MaskFormer keys (and the video keys) + the
    file (where one is named) + the `KEY VALUE` overrides, frozen."""
    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    if video:
        add_maskformer2_video_config(cfg)
    if config_file:
        cfg.merge_from_file(config_file)
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def cfg_device(cfg):
    """The torch device an entry point runs on: MODEL.DEVICE (`cuda` by
    default; `tpu`, as a config written for the JAX package names its
    accelerator, means the CUDA card; `cpu` runs the kernels' plain versions).
    Raises where a CUDA card is asked for and torch finds none."""
    import torch

    device = torch.device("cuda" if cfg.MODEL.DEVICE == "tpu" else cfg.MODEL.DEVICE)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"MODEL.DEVICE {cfg.MODEL.DEVICE}: torch finds no CUDA device; "
                           "pass MODEL.DEVICE cpu to run on the CPU with the kernels' plain "
                           "versions")
    return device
