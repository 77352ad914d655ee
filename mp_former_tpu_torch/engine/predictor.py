"""Serving: one BGR image in, instances at the image's size out.

The port's counterpart of `demo/predictor.py:24-87`, with the serving pieces
of `mp_former_tpu/engine/eval_loop.py`: `preprocess_image` (:50-69) and
`postprocess_instance` (:119-136). The JAX package resizes with cv2 on the
host; here the image goes to the device as uint8 and is resized there with
`F.interpolate` (bilinear, half-pixel centres as cv2's INTER_LINEAR) and
rounded to integers as cv2's uint8 output is, so pixels may differ from cv2's
by a grey level.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..inference import InstanceOutput, instance_inference, sem_seg_postprocess, upsample_masks
from ..models import build_model
from .convert import load_state_dict_file, load_weights, locate_weights


def preprocess_image(cfg, image_bgr: np.ndarray,
                     device: Union[str, torch.device]) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(H, W, 3) uint8 BGR -> ((1, H', W', 3) float32 canvas on `device` in
    INPUT.FORMAT channel order, resized (h, w) before padding). Shortest edge
    to MIN_SIZE_TEST with the long side capped at MAX_SIZE_TEST, padded with
    the pixel mean to a multiple of 32 (normalises to exactly zero)."""
    h, w = image_bgr.shape[:2]
    img = image_bgr[..., ::-1] if cfg.INPUT.FORMAT == "RGB" else image_bgr
    scale = cfg.INPUT.MIN_SIZE_TEST / min(h, w)
    if max(h, w) * scale > cfg.INPUT.MAX_SIZE_TEST:
        scale = cfg.INPUT.MAX_SIZE_TEST / max(h, w)
    rh, rw = int(h * scale + 0.5), int(w * scale + 0.5)
    nh, nw = (rh + 31) // 32 * 32, (rw + 31) // 32 * 32
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    x = x.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False)
    x = x.round_().clamp_(0, 255)[0].permute(1, 2, 0)
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32, device=x.device)
    canvas = mean.expand(nh, nw, 3).clone()
    canvas[:rh, :rw] = x
    return canvas[None], (rh, rw)


def postprocess_instance(logits: torch.Tensor, masks: torch.Tensor, image_size: Tuple[int, int],
                         out_h: int, out_w: int, num_classes: int,
                         topk: int = 100) -> InstanceOutput:
    """logits (Q, K+1), masks (Q, h4, w4) at 1/4 of the padded canvas ->
    instances at (out_h, out_w), in the reference's order: upsample to the
    canvas, crop the padding, resize to the original size, then score."""
    m = upsample_masks(masks, (masks.shape[1] * 4, masks.shape[2] * 4))
    m = sem_seg_postprocess(m, image_size, out_h, out_w)
    return instance_inference(logits, m, num_classes, topk)


class Predictor:
    """cfg (+ MODEL.WEIGHTS, or a ready model) -> callable(image_bgr) ->
    {"instances": {"scores", "classes", "masks"}} as host arrays."""

    def __init__(self, cfg, model: Optional[torch.nn.Module] = None,
                 device: Union[str, torch.device] = "cuda"):
        if not cfg.MODEL.MASK_FORMER.TEST.INSTANCE_ON:
            raise NotImplementedError("the port serves instance segmentation only so far")
        self.cfg = cfg
        self.device = torch.device(device)
        if model is None:
            model = build_model(cfg)
            if cfg.MODEL.WEIGHTS:
                # a fresh model would report near-zero AP without a word: raise
                local = locate_weights(cfg.MODEL.WEIGHTS)
                if local is None:
                    raise FileNotFoundError(f"MODEL.WEIGHTS {cfg.MODEL.WEIGHTS} not found locally "
                                            "(download it or point MODEL.WEIGHTS at a file)")
                load_weights(model, load_state_dict_file(local))
        self.model = model.to(self.device).eval()

    def preprocess(self, image_bgr: np.ndarray):
        return preprocess_image(self.cfg, image_bgr, self.device)

    @torch.inference_mode()
    def forward_raw(self, image_bgr: np.ndarray):
        """(logits (Q, K+1), mask logits (Q, h4, w4), resized (h, w)), on
        the device."""
        canvas, image_size = self.preprocess(image_bgr)
        out = self.model(canvas)
        return out["pred_logits"][0], out["pred_masks"][0], image_size

    @torch.inference_mode()
    def __call__(self, image_bgr: np.ndarray,
                 out_hw: Optional[Tuple[int, int]] = None) -> Dict:
        """Instances at `out_hw`, by default the image's own size."""
        h, w = out_hw or image_bgr.shape[:2]
        logits, masks, image_size = self.forward_raw(image_bgr)
        inst = postprocess_instance(logits, masks, image_size, h, w,
                                    self.cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                    self.cfg.TEST.DETECTIONS_PER_IMAGE)
        # a bfloat16 model's scores are bfloat16, which numpy has no type for
        return {"instances": {"scores": inst.scores.float().cpu().numpy(),
                              "classes": inst.pred_classes.cpu().numpy(),
                              "masks": inst.pred_masks.cpu().numpy()}}
