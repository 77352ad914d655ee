"""The benchmark's inputs, made from the seed: a frozen copy of the port's
seeded batch generator (`mp_former_tpu_torch/data/synthetic.py`) and a
generator of COCO-sized images. The program receives only what these make.

Training batches are in the format the port's loader hands over in grid mode
(`TPU.GT_MASK_STRIDE` 0 resolves to 4 there): uint8 images (B, S, S, 3), the
targets at 1/4 of the canvas, padded to a fixed number of slots, valid slots
first, boxes cxcywh in [0, 1]. Each instance is a rectangle or an ellipse
painted into the image in a colour of its class, so the task can be learnt.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class Targets(NamedTuple):
    labels: torch.Tensor   # (B, N) int64
    masks: torch.Tensor    # (B, N, S / stride, S / stride) bool
    boxes: torch.Tensor    # (B, N, 4) float32 cxcywh
    valid: torch.Tensor    # (B, N) bool


def _shape_mask(rng: np.random.RandomState, size: int) -> np.ndarray:
    """One rectangle or ellipse of 1/8 to 1/2 of the grid's side."""
    h, w = rng.randint(size // 8, size // 2 + 1, 2)
    y0, x0 = rng.randint(0, size - h + 1), rng.randint(0, size - w + 1)
    mask = np.zeros((size, size), dtype=bool)
    if rng.rand() < 0.5:
        mask[y0:y0 + h, x0:x0 + w] = True
    else:
        yy, xx = np.mgrid[:size, :size]
        cy, cx = y0 + (h - 1) / 2, x0 + (w - 1) / 2
        mask[((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2 <= 1.0] = True
    return mask


def train_batch(rng: np.random.RandomState, image_size: int, num_classes: int, slots: int,
                instances: Sequence[int], stride: int) -> Tuple[torch.Tensor, Targets]:
    """One batch on the host: (images, targets), an image for each entry of
    `instances`, which holds as many instances as that entry says, in a
    seeded order: every batch of every seed holds the same counts."""
    batch_size, grid = len(instances), image_size // stride
    counts = [int(instances[i]) for i in rng.permutation(batch_size)]
    images = rng.randint(0, 256, (batch_size, image_size, image_size, 3)).astype(np.uint8)
    labels = np.zeros((batch_size, slots), dtype=np.int64)
    masks = np.zeros((batch_size, slots, grid, grid), dtype=bool)
    boxes = np.zeros((batch_size, slots, 4), dtype=np.float32)
    valid = np.zeros((batch_size, slots), dtype=bool)
    for b in range(batch_size):
        for n in range(min(counts[b], slots)):
            mask = _shape_mask(rng, grid)
            label = rng.randint(num_classes)
            ys, xs = np.nonzero(mask)
            x0, x1, y0, y1 = xs.min(), xs.max() + 1, ys.min(), ys.max() + 1
            labels[b, n], masks[b, n], valid[b, n] = label, mask, True
            boxes[b, n] = np.array([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0]) / grid
            # the class shows as a colour over the noise, at the image's resolution
            full = mask.repeat(stride, 0).repeat(stride, 1)
            colour = np.array([(label * 37) % 256, (label * 91) % 256, (label * 151) % 256])
            images[b][full] = (images[b][full] // 4 + colour * 3 // 4).astype(np.uint8)
    return (torch.from_numpy(images),
            Targets(torch.from_numpy(labels), torch.from_numpy(masks),
                    torch.from_numpy(boxes), torch.from_numpy(valid)))


def train_pool(seed: int, count: int, **kwargs) -> List[Tuple[torch.Tensor, Targets]]:
    """`count` distinct batches from `seed`."""
    rng = np.random.RandomState(seed % 2 ** 32)
    return [train_batch(rng, **kwargs) for _ in range(count)]


def request_images(seed: int, count: int, sizes: Sequence[Sequence[int]]) -> List[np.ndarray]:
    """`count` uint8 BGR images, each of a (width, height) of `sizes` drawn
    uniformly, from `seed`. Each image is smooth noise with a few flat boxes,
    so that it is neither constant nor white noise."""
    rng = np.random.RandomState(seed % 2 ** 32)
    out = []
    for _ in range(count):
        w, h = sizes[rng.randint(len(sizes))]
        coarse = rng.randint(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.uint8)
        img = coarse.repeat(16, 0).repeat(16, 1)[:h, :w].copy()
        for _ in range(rng.randint(1, 8)):
            bh, bw = rng.randint(h // 10, h // 2), rng.randint(w // 10, w // 2)
            y0, x0 = rng.randint(0, h - bh), rng.randint(0, w - bw)
            img[y0:y0 + bh, x0:x0 + bw] = rng.randint(0, 256, 3)
        out.append(img)
    return out
