"""Serving in plain PyTorch: a frozen copy of the port's preprocessing and
instance post-processing (`engine/predictor.py`, `inference.py`), which the
benchmark's serving cells compare with what the port's `Predictor` returns.
`instance_scores` gives the score every (query, class) pair would have, so
that a detection of the port can be judged whatever order the top-k puts it
in."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .utils.interp import resize


def resize_uint8(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) uint8, bilinear with half-pixel centres
    (cv2's INTER_LINEAR), rounded."""
    x = img.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    return x.round_().clamp_(0, 255)[0].permute(1, 2, 0).to(torch.uint8)


def preprocess_image(cfg, image_bgr: np.ndarray, device) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(H, W, 3) uint8 BGR -> ((1, H', W', 3) float32 canvas in INPUT.FORMAT
    order, the resized (h, w)): shortest edge to MIN_SIZE_TEST, the long side
    capped at MAX_SIZE_TEST, padded with the pixel mean to a multiple of 32."""
    h, w = image_bgr.shape[:2]
    img = image_bgr[..., ::-1] if cfg.INPUT.FORMAT == "RGB" else image_bgr
    scale = cfg.INPUT.MIN_SIZE_TEST / min(h, w)
    if max(h, w) * scale > cfg.INPUT.MAX_SIZE_TEST:
        scale = cfg.INPUT.MAX_SIZE_TEST / max(h, w)
    rh, rw = int(h * scale + 0.5), int(w * scale + 0.5)
    nh, nw = (rh + 31) // 32 * 32, (rw + 31) // 32 * 32
    x = resize_uint8(torch.from_numpy(np.ascontiguousarray(img)).to(device), rh, rw).float()
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32, device=x.device)
    canvas = mean.expand(nh, nw, 3).clone()
    canvas[:rh, :rw] = x
    return canvas[None], (rh, rw)


def upsample_masks(mask_pred: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w) -> (..., H, W) bilinear (reference :239-244)."""
    return resize(mask_pred, size, "bilinear")


def sem_seg_postprocess(result: torch.Tensor, img_size: Tuple[int, int],
                        out_h: int, out_w: int) -> torch.Tensor:
    """Crop the padding, then resize to the output size (d2
    sem_seg_postprocess, reference :256-259). result (C, H_pad, W_pad)."""
    return resize(result[:, :img_size[0], :img_size[1]], (out_h, out_w), "bilinear")


def masks_at_output(masks: torch.Tensor, image_size: Tuple[int, int], out_h: int,
                    out_w: int) -> torch.Tensor:
    """(Q, h4, w4) mask logits -> (Q, out_h, out_w): upsample to the padded
    canvas, crop the padding, resize to the output size."""
    m = upsample_masks(masks, (masks.shape[1] * 4, masks.shape[2] * 4))
    return sem_seg_postprocess(m, image_size, out_h, out_w)


def instance_scores(mask_cls: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(Q, K+1) logits, (Q, H, W) mask logits at the output size -> (Q, K):
    the score that instance inference (reference :365-401) gives each
    (query, class) pair it keeps: class probability x the mean foreground
    probability of the binary mask."""
    binf = (masks > 0).to(masks.dtype)
    mask_scores = (masks.sigmoid() * binf).flatten(1).sum(1) / (binf.flatten(1).sum(1) + 1e-6)
    return mask_cls.softmax(-1)[:, :-1] * mask_scores[:, None]
