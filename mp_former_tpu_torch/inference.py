"""Post-processing of the three tasks (reference maskformer_model.py:233-401,
`mp_former_tpu/inference.py`): `semantic_inference`, `instance_inference` and
`panoptic_inference`, whose per-pixel scoring runs on the device
(`panoptic_inference_device`) and whose sequential stuff-merging loop runs on
the host over at most Q segments."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .utils.interp import resize


def upsample_masks(mask_pred: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w) -> (..., H, W) bilinear (reference :239-244)."""
    return resize(mask_pred, size, "bilinear")


def sem_seg_postprocess(result: torch.Tensor, img_size: Tuple[int, int],
                        out_h: int, out_w: int) -> torch.Tensor:
    """Crop the padding, then resize to the output size (d2
    sem_seg_postprocess, reference :256-259). result (C, H_pad, W_pad)."""
    return resize(result[:, :img_size[0], :img_size[1]], (out_h, out_w), "bilinear")


def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
    """Class probabilities without the no-object column times the mask
    probabilities, summed over the queries (reference :301-305).
    mask_cls (..., Q, K+1), mask_pred (..., Q, H, W) -> (..., K, H, W)."""
    probs = mask_cls.softmax(-1)[..., :-1]
    return torch.einsum("...qc,...qhw->...chw", probs, mask_pred.sigmoid())


class InstanceOutput(NamedTuple):
    """Fixed-size (top-k) instance predictions of one image."""

    scores: torch.Tensor        # (topk,)
    pred_classes: torch.Tensor  # (topk,) int64
    pred_masks: torch.Tensor    # (topk, H, W) bool


def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor, num_classes: int,
                       test_topk_per_image: int = 100) -> InstanceOutput:
    """mask_cls (Q, K+1), mask_pred (Q, H, W) logits at output resolution
    (reference instance_inference :365-401): top-k over all (query, class)
    scores, then score x mean foreground probability of the binary mask."""
    scores = mask_cls.softmax(-1)[:, :-1]
    topk_scores, topk_idx = scores.flatten().topk(test_topk_per_image, sorted=True)
    labels = topk_idx % num_classes
    masks = mask_pred[topk_idx // num_classes]
    binary = masks > 0
    binf = binary.to(masks.dtype)
    mask_scores = (masks.sigmoid() * binf).flatten(1).sum(1) / (binf.flatten(1).sum(1) + 1e-6)
    return InstanceOutput(scores=topk_scores * mask_scores, pred_classes=labels,
                          pred_masks=binary)


def panoptic_inference_device(mask_cls: torch.Tensor, mask_pred: torch.Tensor, num_classes: int,
                              object_mask_threshold: float):
    """The device part of reference panoptic_inference (:307-341): scores, the
    keep filter, the per-pixel argmax over the score-weighted mask
    probabilities (-1.0 for a query not kept), the binary masks (sigmoid >=
    0.5) and each query's areas. mask_cls (Q, K+1), mask_pred (Q, H, W)
    logits. Returns (keep, labels, mask_ids, binary, mask_area,
    original_area, final_area)."""
    scores, labels = mask_cls.softmax(-1).max(-1)
    sig = mask_pred.sigmoid()
    keep = (labels != num_classes) & (scores > object_mask_threshold)
    prob_masks = torch.where(keep[:, None, None], scores[:, None, None] * sig,
                             torch.full_like(sig, -1.0))
    mask_ids = prob_masks.argmax(0)  # (H, W); meaningless where nothing is kept
    binary = sig >= 0.5
    original_area = binary.flatten(1).sum(1)
    assigned = mask_ids[None] == torch.arange(mask_pred.shape[0], device=mask_pred.device)[:, None,
                                                                                            None]
    mask_area = assigned.flatten(1).sum(1)
    final_area = (assigned & binary).flatten(1).sum(1)
    return keep, labels, mask_ids, binary, mask_area, original_area, final_area


def panoptic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor, num_classes: int,
                       object_mask_threshold: float, overlap_threshold: float,
                       is_thing: np.ndarray) -> Tuple[np.ndarray, List[Dict]]:
    """Panoptic fusion (reference :307-363): `panoptic_inference_device`,
    then the sequential merge on the host. `is_thing` (K,) bool over the
    contiguous class ids. Returns (the (H, W) int32 id map, 0 where no segment
    lies, and the segments [{"id" from 1, "isthing", "category_id"}]); a
    query whose mask keeps less than `overlap_threshold` of its area after the
    argmax is dropped, and the segments of one stuff class are merged."""
    keep, labels, mask_ids, binary, mask_area, original_area, final_area = (
        t.cpu().numpy() for t in panoptic_inference_device(mask_cls, mask_pred, num_classes,
                                                            object_mask_threshold))
    panoptic_seg = np.zeros(binary.shape[-2:], dtype=np.int32)
    segments_info: List[Dict] = []
    current_segment_id = 0
    stuff_memory: Dict[int, int] = {}
    for k in np.flatnonzero(keep):
        pred_class = int(labels[k])
        isthing = bool(is_thing[pred_class])
        if not (mask_area[k] > 0 and original_area[k] > 0 and final_area[k] > 0):
            continue
        if mask_area[k] / original_area[k] < overlap_threshold:
            continue
        mask = (mask_ids == k) & binary[k]
        if not isthing:
            if pred_class in stuff_memory:
                panoptic_seg[mask] = stuff_memory[pred_class]
                continue
            stuff_memory[pred_class] = current_segment_id + 1
        current_segment_id += 1
        panoptic_seg[mask] = current_segment_id
        segments_info.append({"id": current_segment_id, "isthing": isthing,
                              "category_id": pred_class})
    return panoptic_seg, segments_info
