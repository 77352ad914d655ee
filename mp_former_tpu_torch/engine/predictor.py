"""Serving: one BGR image in, the tasks that MASK_FORMER.TEST switches on out,
at the image's size, all from one forward: instances (INSTANCE_ON), semantic
class probabilities (SEMANTIC_ON) and the panoptic id map with its segments
(PANOPTIC_ON).

The port's counterpart of `demo/predictor.py:24-87`, with the serving pieces
of `mp_former_tpu/engine/eval_loop.py`: `preprocess_image` (:50-69),
`postprocess_instance` (:119-136), `semantic_before_inference`,
`postprocess_semantic` and `postprocess_panoptic` (:139-181) and the task
switch of `run_evaluation`'s `postprocess` (:291-308). As there, instances
are not filtered by class when PANOPTIC_ON is set (the reference's
maskformer_model.py:384-391 zeroes the scores of stuff classes; ROADMAP §C).
The JAX package resizes with cv2 on the
host; here the image goes to the device as uint8 and is resized there with
`F.interpolate` (bilinear, half-pixel centres as cv2's INTER_LINEAR) and
rounded to integers as cv2's uint8 output is, so pixels may differ from cv2's
by a grey level.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..inference import (InstanceOutput, instance_inference, panoptic_inference,
                         sem_seg_postprocess, semantic_inference, upsample_masks)
from ..models import build_model
from .convert import load_state_dict_file, load_weights, locate_weights

logger = logging.getLogger(__name__)

# a task and the key of the Predictor's result that carries it
TASK_KEYS = {"instance": "instances", "semantic": "sem_seg", "panoptic": "panoptic_seg"}


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


def _masks_at_output(masks: torch.Tensor, image_size: Tuple[int, int], out_h: int,
                     out_w: int) -> torch.Tensor:
    """(Q, h4, w4) mask logits -> (Q, out_h, out_w): upsample to the padded
    canvas, crop the padding, resize to the output size."""
    m = upsample_masks(masks, (masks.shape[1] * 4, masks.shape[2] * 4))
    return sem_seg_postprocess(m, image_size, out_h, out_w)


def postprocess_instance(logits: torch.Tensor, masks: torch.Tensor, image_size: Tuple[int, int],
                         out_h: int, out_w: int, num_classes: int,
                         topk: int = 100) -> InstanceOutput:
    """logits (Q, K+1), masks (Q, h4, w4) at 1/4 of the padded canvas ->
    instances at (out_h, out_w), in the reference's order: upsample to the
    canvas, crop the padding, resize to the original size, then score."""
    return instance_inference(logits, _masks_at_output(masks, image_size, out_h, out_w),
                              num_classes, topk)


def semantic_before_inference(cfg) -> bool:
    """Reference from_config (maskformer_model.py:157-161): the semantic crop
    and resize run BEFORE semantic_inference when the flag is set, or when
    panoptic or instance inference is on too."""
    t = cfg.MODEL.MASK_FORMER.TEST
    return bool(t.SEM_SEG_POSTPROCESSING_BEFORE_INFERENCE or t.PANOPTIC_ON or t.INSTANCE_ON)


def postprocess_semantic(logits: torch.Tensor, masks: torch.Tensor, image_size: Tuple[int, int],
                         out_h: int, out_w: int, before_inference: bool = False) -> torch.Tensor:
    """(Q, K+1), (Q, h4, w4) -> (K, out_h, out_w) class probabilities, in
    float32, in the reference's order: with `before_inference` (reference
    sem_seg_postprocess_before_inference, maskformer_model.py:256-266) the
    masks are cropped and resized first and `semantic_inference` runs at the
    output size; otherwise it runs on the padded canvas and its maps are
    cropped and resized."""
    logits, masks = logits.float(), masks.float()
    if before_inference:
        return semantic_inference(logits, _masks_at_output(masks, image_size, out_h, out_w))
    m = upsample_masks(masks, (masks.shape[1] * 4, masks.shape[2] * 4))
    return sem_seg_postprocess(semantic_inference(logits, m), image_size, out_h, out_w)


def postprocess_panoptic(logits: torch.Tensor, masks: torch.Tensor, image_size: Tuple[int, int],
                         out_h: int, out_w: int, num_classes: int, object_mask_threshold: float,
                         overlap_threshold: float,
                         is_thing: np.ndarray) -> Tuple[np.ndarray, List[Dict]]:
    """Panoptic fusion at the output size (reference :270-272; the masks are
    resized before the fusion, as PANOPTIC_ON forces the before-inference
    order, maskformer_model.py:150-153), in float32."""
    return panoptic_inference(logits.float(),
                              _masks_at_output(masks.float(), image_size, out_h, out_w),
                              num_classes, object_mask_threshold, overlap_threshold, is_thing)


def switched_tasks(cfg) -> List[str]:
    """The tasks MASK_FORMER.TEST switches on, in TASK_KEYS' order."""
    t = cfg.MODEL.MASK_FORMER.TEST
    on = {"instance": t.INSTANCE_ON, "semantic": t.SEMANTIC_ON, "panoptic": t.PANOPTIC_ON}
    return [task for task in TASK_KEYS if on[task]]


class Predictor:
    """cfg (+ MODEL.WEIGHTS, or a ready model) -> callable(image_bgr) -> the
    switched-on tasks as host arrays: {"instances": {"scores", "classes",
    "masks"}, "sem_seg": (K, H, W) float32 probabilities, "panoptic_seg": ((H,
    W) int32 id map, segments)}. `is_thing` (K,) bool marks the thing classes
    for the panoptic fusion; by default the `thing_map` of DATASETS.TEST[0]'s
    metadata, every class a thing where it has none."""

    def __init__(self, cfg, model: Optional[torch.nn.Module] = None,
                 device: Union[str, torch.device] = "cuda",
                 is_thing: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.tasks = switched_tasks(cfg)
        if not self.tasks:
            logger.warning("MASK_FORMER.TEST switches no task on: the predictor returns {}")
        if is_thing is None:
            from ..data.catalog import MetadataCatalog
            from ..evaluation.build import is_thing_array

            names = cfg.DATASETS.TEST
            is_thing = is_thing_array(cfg, MetadataCatalog.get(names[0]) if names else {})
        self.is_thing = np.asarray(is_thing, bool)
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
    def __call__(self, image_bgr: np.ndarray, out_hw: Optional[Tuple[int, int]] = None,
                 tasks: Optional[Sequence[str]] = None, sem_seg_labels: bool = False) -> Dict:
        """The `tasks` (by default those MASK_FORMER.TEST switches on) at
        `out_hw`, by default the image's own size, from one forward.
        `sem_seg_labels`: "sem_seg" as the (H, W) int64 argmax over the
        classes, taken on the device, instead of the probabilities."""
        h, w = out_hw or image_bgr.shape[:2]
        logits, masks, image_size = self.forward_raw(image_bgr)
        cfg = self.cfg
        num_classes = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        out = {}
        for task in self.tasks if tasks is None else tasks:
            if task == "instance":
                inst = postprocess_instance(logits, masks, image_size, h, w, num_classes,
                                            cfg.TEST.DETECTIONS_PER_IMAGE)
                # a bfloat16 model's scores are bfloat16, which numpy has no type for
                out["instances"] = {"scores": inst.scores.float().cpu().numpy(),
                                    "classes": inst.pred_classes.cpu().numpy(),
                                    "masks": inst.pred_masks.cpu().numpy()}
            elif task == "semantic":
                probs = postprocess_semantic(logits, masks, image_size, h, w,
                                             semantic_before_inference(cfg))
                out["sem_seg"] = (probs.argmax(0) if sem_seg_labels else probs).cpu().numpy()
            elif task == "panoptic":
                t = cfg.MODEL.MASK_FORMER.TEST
                out["panoptic_seg"] = postprocess_panoptic(
                    logits, masks, image_size, h, w, num_classes, t.OBJECT_MASK_THRESHOLD,
                    t.OVERLAP_THRESHOLD, self.is_thing)
            else:
                raise ValueError(f"Predictor: unknown task {task!r} (known: {list(TASK_KEYS)})")
        return out
