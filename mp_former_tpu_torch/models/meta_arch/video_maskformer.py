"""VideoMaskFormer meta-architecture (reference
mask2former_video/video_maskformer_model.py:24-287,
`mp_former_tpu/video/video_maskformer.py:31-70`).

Takes raw clips (B, T, H, W, 3) in `INPUT.FORMAT` channel order, H and W
padded to a multiple of 32, any dtype: normalises them, runs the backbone and
the pixel decoder on the B*T frames as one batch (reference :180-188) and
hands the frames' maps to the temporal decoder with the clips' length T, so a
clip runs at its own length. Returns `pred_logits` (B, Q, K+1), `pred_masks`
(B, Q, T, H/4, W/4) and `aux_outputs`, in serving and in training alike: the
reference's video stack has no DN (mask-piloted) path, so `targets` and
`dn_groups` change nothing in the forward (the losses take the targets,
`video/criterion.py`), and `scalar` is 0, so that `engine/train_step.py`
asks for no DN groups. `TPU.COMPUTE_DTYPE bfloat16` and `TPU.REMAT_ENCODER`
work as in `MaskFormer`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...utils import compute_region
from ...utils.registry import META_ARCH_REGISTRY
from .maskformer import MaskFormer


@META_ARCH_REGISTRY.register()
class VideoMaskFormer(MaskFormer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.scalar = 0  # no DN queries

    def forward(self, images: torch.Tensor, targets=None, dn_groups=None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """images (B, T, H, W, 3) raw pixels. `targets` (`VideoTargets`) and
        `dn_groups` are accepted for the training step and ignored, as the
        JAX model ignores `dn_groups`; `generator` feeds the pixel decoder's
        dropout in training mode."""
        if images.dim() != 5:
            raise ValueError(f"clips must be (B, T, H, W, 3), got {tuple(images.shape)}")
        x = self.normalized(images)
        with compute_region(x.device.type, self.compute_dtype):
            return self.sem_seg_head(self.backbone(x), generator=generator,
                                     num_frames=images.shape[1])
