"""VideoMaskFormer meta-architecture (reference
mask2former_video/video_maskformer_model.py:24-287,
`mp_former_tpu/video/video_maskformer.py:31-70`), inference.

Takes raw clips (B, T, H, W, 3) in `INPUT.FORMAT` channel order, H and W
padded to a multiple of 32, any dtype: normalises them, runs the backbone and
the pixel decoder on the B*T frames as one batch (reference :180-188) and
hands the frames' maps to the temporal decoder with the clips' length T, so a
clip runs at its own length. Returns `pred_logits` (B, Q, K+1), `pred_masks`
(B, Q, T, H/4, W/4) and `aux_outputs`. `TPU.COMPUTE_DTYPE bfloat16` works as
in `MaskFormer`. Training (the tube criterion, the clip mappers) is ROADMAP
A20b.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...utils import compute_region
from ...utils.registry import META_ARCH_REGISTRY
from .maskformer import MaskFormer


@META_ARCH_REGISTRY.register()
class VideoMaskFormer(MaskFormer):
    def forward(self, images: torch.Tensor, targets=None) -> Dict:
        if targets is not None:
            raise NotImplementedError("VideoMaskFormer serves only: video training (the tube "
                                      "criterion and the clip mappers) is ROADMAP A20b")
        if images.dim() != 5:
            raise ValueError(f"clips must be (B, T, H, W, 3), got {tuple(images.shape)}")
        x = self.normalized(images)
        with compute_region(x.device.type, self.compute_dtype):
            return self.sem_seg_head(self.backbone(x), num_frames=images.shape[1])
