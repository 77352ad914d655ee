"""SemanticSegmentorWithTTA (reference test_time_augmentation.py:21-103;
`mp_former_tpu/test_time_augmentation.py`): multi-scale and horizontal-flip
test-time augmentation for semantic segmentation. The model runs at each
scale, and mirrored; each pass's class probabilities are taken at the
original size and all passes are averaged.

Each pass is one forward of the model on its device (on the card: K1 6 and
K3 9 launches a pass with the MSDeformAttn pixel decoder and the masked
decoder). The resize runs there too, without cv2: `data/transforms.py`'s
half-pixel bilinear rounded to uint8, within a grey level of cv2's
INTER_LINEAR. As in the JAX package, no entry point wires it in:
`TEST.AUG.ENABLED` is not read.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .data.transforms import resize_uint8
from .inference import semantic_inference
from .utils.interp import resize


def tta_size(h: int, w: int, size: int, max_size: int) -> Tuple[int, int]:
    """The (h, w) a pass runs at: the short side to `size` (rounded), the
    long side capped at `max_size`, both up to a multiple of 32
    (`mp_former_tpu/test_time_augmentation.py:39-47`)."""
    scale = size / min(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    if max(nh, nw) > max_size:
        s = max_size / max(nh, nw)
        nh, nw = int(nh * s), int(nw * s)
    return (nh + 31) // 32 * 32, (nw + 31) // 32 * 32


class SemanticSegmentorWithTTA:
    """cfg (TEST.AUG.MIN_SIZES, MAX_SIZE, FLIP) + a built model ->
    callable((H, W, 3) RGB uint8) -> (K, H, W) float32 averaged class
    probabilities. The passes run where the model's parameters are."""

    def __init__(self, cfg, model: torch.nn.Module):
        self.model = model
        self.min_sizes = list(cfg.TEST.AUG.MIN_SIZES)
        self.max_size = cfg.TEST.AUG.MAX_SIZE
        self.flip = cfg.TEST.AUG.FLIP
        self.num_classes = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def passes(self, image: np.ndarray):
        """(size, flipped, (K, H, W) float32 probabilities on the device) of
        each pass, in the order they are averaged."""
        h, w = image.shape[:2]
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        for size in self.min_sizes:
            nh, nw = tta_size(h, w, size, self.max_size)
            resized = resize_uint8(img, nh, nw)
            variants = [resized, resized.flip(1)] if self.flip else [resized]
            for flipped, v in enumerate(variants):
                out = self.model(v[None].float())
                masks = resize(out["pred_masks"].float(), (h, w), "bilinear")
                sem = semantic_inference(out["pred_logits"][0].float(), masks[0])
                yield size, bool(flipped), sem.flip(-1) if flipped else sem

    @torch.inference_mode()
    def __call__(self, image: np.ndarray) -> np.ndarray:
        acc, n = None, 0
        for _, _, sem in self.passes(image):
            acc = sem if acc is None else acc + sem
            n += 1
        return (acc / n).cpu().numpy()
