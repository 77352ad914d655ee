"""Seeded in-memory training batches: random images with a few rectangles and
ellipses as instances. Stands in for the dataset loader and mappers until
they are ported; the shapes are painted into the image, so the task can be
learnt."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..structures import Batch, Targets


def _shape_mask(rng: np.random.RandomState, size: int) -> np.ndarray:
    """One rectangle or ellipse of 1/8 to 1/2 of the image's side."""
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


def synthetic_batch(rng: np.random.RandomState, batch_size: int, image_size: int,
                    num_classes: int, max_instances: int, min_objects: int = 1,
                    max_objects: int = 6) -> Batch:
    """One batch on the CPU: uint8 images (B, S, S, 3), targets padded to
    `max_instances` slots, valid slots first, boxes cxcywh in [0, 1]."""
    images = rng.randint(0, 256, (batch_size, image_size, image_size, 3)).astype(np.uint8)
    labels = np.zeros((batch_size, max_instances), dtype=np.int64)
    masks = np.zeros((batch_size, max_instances, image_size, image_size), dtype=bool)
    boxes = np.zeros((batch_size, max_instances, 4), dtype=np.float32)
    valid = np.zeros((batch_size, max_instances), dtype=bool)
    for b in range(batch_size):
        for n in range(rng.randint(min_objects, min(max_objects, max_instances) + 1)):
            mask = _shape_mask(rng, image_size)
            label = rng.randint(num_classes)
            ys, xs = np.nonzero(mask)
            x0, x1, y0, y1 = xs.min(), xs.max() + 1, ys.min(), ys.max() + 1
            labels[b, n], masks[b, n], valid[b, n] = label, mask, True
            boxes[b, n] = np.array([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0]) / image_size
            # the class shows as a colour, over the noise
            colour = np.array([(label * 37) % 256, (label * 91) % 256, (label * 151) % 256])
            images[b][mask] = (images[b][mask] // 4 + colour * 3 // 4).astype(np.uint8)
    return Batch(torch.from_numpy(images),
                 Targets(torch.from_numpy(labels), torch.from_numpy(masks),
                         torch.from_numpy(boxes), torch.from_numpy(valid)))


def synthetic_batches(batch_size: int, image_size: int, num_classes: int, max_instances: int,
                      seed: int = 0, num_batches: Optional[int] = None) -> Iterator[Batch]:
    """An iterator of seeded batches (endless when `num_batches` is None)."""
    rng = np.random.RandomState(seed)
    n = 0
    while num_batches is None or n < num_batches:
        yield synthetic_batch(rng, batch_size, image_size, num_classes, max_instances)
        n += 1
