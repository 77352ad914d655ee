"""YTVISEvaluator: video instance AP over spatio-temporal tubes (reference
mask2former_video/data_video/ytvis_eval.py:27-115 with its vendored
ytvoseval; the port's copy of `mp_former_tpu/video/ytvis_eval.py:16-58`).
A tube's IoU is the IoU of its time-flattened masks, so the COCOeval core
(`evaluation/coco_eval.py:CocoAPEvaluator`) scores (T*H, W) masks;
`merge_from` folds in another rank's evaluator."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..evaluation.coco_eval import CocoAPEvaluator
from .ytvis import _seg_to_mask


class YTVISEvaluator:
    def __init__(self, dataset_records: List[dict], max_dets: int = 100):
        self._gt_by_id = {r["video_id"]: r for r in dataset_records}
        self.max_dets = max_dets
        self.reset()

    def reset(self):
        self._ap = CocoAPEvaluator("segm", self.max_dets)

    def merge_from(self, other: "YTVISEvaluator") -> None:
        self._ap.merge_from(other._ap)

    def process(self, video_id, scores: np.ndarray, classes: np.ndarray,
                tube_masks: List[np.ndarray]):
        """tube_masks: list of (T, H, W) bool at original resolution."""
        rec = self._gt_by_id[video_id]
        h, w = rec["height"], rec["width"]
        t = tube_masks[0].shape[0] if len(tube_masks) else rec["length"]
        gt_cats, gt_tubes, gt_crowd, gt_areas = [], [], [], []
        for a in rec["annotations"]:
            tube = np.zeros((t, h, w), bool)
            segs = a.get("segmentations") or []
            for fi in range(min(t, len(segs))):
                m = _seg_to_mask(segs[fi], h, w)
                if m is not None:
                    tube[fi] = m
            gt_cats.append(a["category_id"])
            gt_tubes.append(tube.reshape(t * h, w))
            gt_crowd.append(bool(a.get("iscrowd", 0)))
            area_vals = [x for x in a.get("areas") or [] if x]
            gt_areas.append(float(np.mean(area_vals)) if area_vals else tube.sum() / max(t, 1))
        self._ap.add_image(
            det_scores=np.asarray(scores),
            det_cats=np.asarray(classes),
            det_masks_or_boxes=[m.reshape(-1, m.shape[-1]) for m in tube_masks],
            gt_cats=np.asarray(gt_cats, np.int64),
            gt_masks_or_boxes=gt_tubes,
            gt_iscrowd=np.asarray(gt_crowd, bool),
            gt_areas=np.asarray(gt_areas, np.float64))

    def evaluate(self) -> Dict:
        return {"segm": self._ap.summarize()}
