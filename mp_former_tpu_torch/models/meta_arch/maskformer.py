"""MaskFormer meta-architecture (reference maskformer_model.py:20-401,
`mp_former_tpu/models/meta_arch/maskformer.py`).

Takes what `MaskFormer.__call__` takes: raw pixels (B, H, W, 3) in
`INPUT.FORMAT` channel order, padded to a multiple of 32, any dtype.
Normalises, runs backbone -> head and returns the prediction dict
(`pred_logits` (B, Q, K+1), `pred_masks` (B, Q, H/4, W/4), `aux_outputs`).
With `targets` (training) the decoder also runs MP-Former's mask-piloted (DN)
queries and the dict carries `dn_out`. The losses are in `models/criterion.py`,
post-processing in `mp_former_tpu_torch/inference.py`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...structures import DNArgs, Targets
from ...utils.registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY, SEM_SEG_HEADS_REGISTRY


def build_backbone(cfg):
    return BACKBONE_REGISTRY.get(cfg.MODEL.BACKBONE.NAME)(cfg)


def build_sem_seg_head(cfg, input_shape):
    return SEM_SEG_HEADS_REGISTRY.get(cfg.MODEL.SEM_SEG_HEAD.NAME).from_config(cfg, input_shape)


@META_ARCH_REGISTRY.register()
class MaskFormer(nn.Module):
    def __init__(self, backbone: nn.Module, sem_seg_head: nn.Module,
                 pixel_mean: Sequence[float], pixel_std: Sequence[float],
                 size_divisibility: int = 32, scalar: int = 5, noise_scale: float = 0.2,
                 dropout: float = 0.0):
        super().__init__()
        # DN (mask-piloted) training (reference from_config :121-122)
        self.scalar, self.noise_scale = scalar, noise_scale
        self.dropout = dropout
        self.backbone = backbone
        self.sem_seg_head = sem_seg_head
        self.size_divisibility = size_divisibility
        # not in the state dict, as in the reference
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean).view(1, -1, 1, 1), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std).view(1, -1, 1, 1), False)

    @classmethod
    def from_config(cls, cfg):
        backbone = build_backbone(cfg)
        head = build_sem_seg_head(cfg, backbone.output_shape())
        return cls(backbone, head, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                   cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY, cfg.MODEL.DN.NUM_DN,
                   cfg.MODEL.DN.NOISE_SCALE, cfg.MODEL.MASK_FORMER.DROPOUT)

    def forward(self, images: torch.Tensor, targets: Optional[Targets] = None, dn_groups=None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """images (B, H, W, 3) raw pixels, H and W multiples of 32. `targets`
        switches DN training on; `dn_groups` is (groups, batch_max) from
        `engine/train_step.py:compute_dn_groups` for NUM_DN >= 100 (a bare int
        is the group count alone); the DN noise comes from `generator`."""
        div = self.size_divisibility
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
        if div > 0 and (images.shape[1] % div or images.shape[2] % div):
            raise ValueError(f"image size {tuple(images.shape[1:3])} is not padded to /{div}")
        x = images.permute(0, 3, 1, 2).float()
        x = (x - self.pixel_mean) / self.pixel_std
        features = self.backbone(x)
        if targets is None:
            return self.sem_seg_head(features)
        if self.dropout > 0:
            raise NotImplementedError(
                f"MODEL.MASK_FORMER.DROPOUT {self.dropout}: the port carries no dropout (the "
                "recipes train with 0.0, which only the pixel decoder's encoder would read)")
        groups, batch_max = dn_groups if isinstance(dn_groups, tuple) else (dn_groups, None)
        dn_args = DNArgs(targets=targets, scalar=self.scalar, noise_scale=self.noise_scale,
                         groups=groups, batch_max=batch_max)
        return self.sem_seg_head(features, dn_args, generator)
