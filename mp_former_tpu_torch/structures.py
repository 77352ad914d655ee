"""Core data structures of training (`mp_former_tpu/structures.py:17-54`,
`mp_former_tpu/video/video_maskformer.py:20-27`).

Targets are padded to a fixed number of instance slots per image with a
validity mask, as in the JAX package, so that a batch is a few dense tensors
and both packages see the same layout. The JAX package's bit-packing helpers
(`structures.py:57-108`) work around its runtime's host-transfer behaviour and
have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class Targets(NamedTuple):
    """Padded ground truth of a batch.

    labels: (B, N) int64          class ids (junk where invalid)
    masks:  (B, N, H, W) bool     bitmasks at the padded image's resolution,
                                  or at 1/TPU.GT_MASK_STRIDE of it
    boxes:  (B, N, 4) float32     cxcywh, normalised
    valid:  (B, N) bool           which slots are real; real slots come first
    """

    labels: torch.Tensor
    masks: torch.Tensor
    boxes: torch.Tensor
    valid: torch.Tensor

    @property
    def num_instances(self) -> int:
        return self.labels.shape[1]

    def to(self, device, non_blocking: bool = False) -> "Targets":
        return Targets(*(t.to(device, non_blocking=non_blocking) for t in self))

    def first(self, n: int) -> "Targets":
        """The first `n` slots (targets are valid-prefix, so a cap is a slice)."""
        return Targets(*(t[:, :n] for t in self))


class VideoTargets(NamedTuple):
    """Padded ground truth of a batch of clips, one tube a slot.

    labels: (B, N) int64          class ids (junk where invalid)
    masks:  (B, N, T, H, W) bool  bitmasks at the padded frames' resolution
    valid:  (B, N) bool           which slots hold a tube present in some
                                  sampled frame; an invalid slot may sit
                                  between valid ones
    """

    labels: torch.Tensor
    masks: torch.Tensor
    valid: torch.Tensor

    @property
    def num_instances(self) -> int:
        return self.labels.shape[1]

    def to(self, device, non_blocking: bool = False) -> "VideoTargets":
        return VideoTargets(*(t.to(device, non_blocking=non_blocking) for t in self))


class Batch(NamedTuple):
    images: torch.Tensor          # (B, H, W, 3) raw pixels in INPUT.FORMAT order,
                                  # or (B, T, H, W, 3) RGB clips with VideoTargets
    targets: Union[Targets, VideoTargets]

    def to(self, device, non_blocking: bool = False) -> "Batch":
        """On `device`; `non_blocking` copies from pinned memory without
        waiting for the host (the loader pins where the trainer's device is
        CUDA)."""
        return Batch(self.images.to(device, non_blocking=non_blocking),
                     self.targets.to(device, non_blocking=non_blocking))


class DNArgs(NamedTuple):
    """Mask-piloted (DN) training inputs (reference maskformer_model.py:221).

    groups / batch_max: the NUM_DN >= 100 convention, where `scalar` is a
    budget of DN queries: the group count is the budget divided by the batch's
    largest number of instances, and the DN block is compacted to groups *
    batch_max slots (`engine/train_step.py:compute_dn_groups`). None: the
    decoder divides by its instance cap instead."""

    targets: Targets
    scalar: int
    noise_scale: float
    groups: Optional[int] = None
    batch_max: Optional[int] = None
