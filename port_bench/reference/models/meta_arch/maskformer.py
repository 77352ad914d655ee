"""MaskFormer meta-architecture (reference maskformer_model.py:20-401,
`mp_former_tpu/models/meta_arch/maskformer.py`).

Takes what `MaskFormer.__call__` takes: raw pixels (B, H, W, 3) in
`INPUT.FORMAT` channel order, padded to a multiple of 32, any dtype.
Normalises, runs backbone -> head and returns the prediction dict
(`pred_logits` (B, Q, K+1), `pred_masks` (B, Q, H/4, W/4), `aux_outputs`).
With `targets` (training) the decoder also runs MP-Former's mask-piloted (DN)
queries and the dict carries `dn_out`. `MODEL.MASK_FORMER.DROPOUT` acts in
training mode (`.train()`, which `Trainer` sets), drawn from the forward's
`generator`; `build_model` returns the model in `.eval()`. The losses are in
`models/criterion.py`, post-processing in `mp_former_tpu_torch/inference.py`.

`TPU.COMPUTE_DTYPE bfloat16` (`compute_dtype`) is the JAX package's
AMP-equivalent mode: the normalisation stays float32 (JAX `maskformer.py:85-88`),
backbone and head run in a `torch.autocast` region (utils.compute_region) with
the JAX package's types at the modules' boundaries, parameters stay float32,
and `pred_logits` and `pred_masks` come out in bfloat16. The criterion runs
outside the region, in float32 from its casts of the outputs, as the JAX
package's losses do after theirs (autocast would put its matmuls back into
bfloat16).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...structures import DNArgs, Targets
from ...utils import compute_dtype, compute_region
from ..backbone.resnet import build_resnet_backbone
from ..backbone.swin import build_swin_backbone
from .mask_former_head import MaskFormerHead


def build_backbone(cfg):
    """The backbone that MODEL.BACKBONE.NAME names."""
    builders = {"build_resnet_backbone": build_resnet_backbone,
                "D2SwinTransformer": build_swin_backbone}
    name = cfg.MODEL.BACKBONE.NAME
    if name not in builders:
        raise ValueError(f"MODEL.BACKBONE.NAME {name!r} is none of {sorted(builders)}")
    return builders[name](cfg)


class MaskFormer(nn.Module):
    def __init__(self, backbone: nn.Module, sem_seg_head: nn.Module,
                 pixel_mean: Sequence[float], pixel_std: Sequence[float],
                 size_divisibility: int = 32, scalar: int = 5, noise_scale: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        # DN (mask-piloted) training (reference from_config :121-122)
        self.scalar, self.noise_scale = scalar, noise_scale
        self.backbone = backbone
        self.sem_seg_head = sem_seg_head
        self.size_divisibility = size_divisibility
        # not in the state dict, as in the reference
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean).view(1, -1, 1, 1), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std).view(1, -1, 1, 1), False)

    @classmethod
    def from_config(cls, cfg):
        if cfg.MODEL.META_ARCHITECTURE != "MaskFormer" or \
                cfg.MODEL.SEM_SEG_HEAD.NAME != "MaskFormerHead" or cfg.MODEL.DN.NUM_DN >= 100:
            raise ValueError("the reference builds MaskFormer with MaskFormerHead, NUM_DN < 100")
        backbone = build_backbone(cfg)
        head = MaskFormerHead.from_config(cfg, backbone.output_shape())
        return cls(backbone, head, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                   cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY, cfg.MODEL.DN.NUM_DN,
                   cfg.MODEL.DN.NOISE_SCALE, compute_dtype(cfg))

    def normalized(self, images: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3) raw pixels, H and W multiples of SIZE_DIVISIBILITY ->
        (N, 3, H, W) float32, normalised, the leading dimensions flattened."""
        div = self.size_divisibility
        if images.shape[-1] != 3:
            raise ValueError(f"images must end in 3 channels, got {tuple(images.shape)}")
        if div > 0 and (images.shape[-3] % div or images.shape[-2] % div):
            raise ValueError(f"image size {tuple(images.shape[-3:-1])} is not padded to /{div}")
        x = images.reshape(-1, *images.shape[-3:]).permute(0, 3, 1, 2).float()
        return (x - self.pixel_mean) / self.pixel_std

    def forward(self, images: torch.Tensor, targets: Optional[Targets] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """images (B, H, W, 3) raw pixels, H and W multiples of 32. `targets`
        switches DN training on; the DN noise and the dropout masks come from
        `generator`."""
        if images.dim() != 4:
            raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
        x = self.normalized(images)
        with compute_region(x.device.type, self.compute_dtype):
            features = self.backbone(x)
            if targets is None:
                return self.sem_seg_head(features, generator=generator)
            dn_args = DNArgs(targets=targets, scalar=self.scalar, noise_scale=self.noise_scale)
            return self.sem_seg_head(features, dn_args, generator)
