"""LVIS mask AP (the reference dispatches evaluator_type "lvis" to d2's
LVISEvaluator, train_net.py:214-215, which wraps the lvis-api); the port's
copy of `mp_former_tpu/evaluation/lvis_eval.py`, on the numpy COCOeval core
of `coco_eval.py`.

LVIS differs from COCO evaluation in three ways:

1. Federated evaluation: an image judges only the categories it was
   annotated for, its positive set (ground truth) and its
   `neg_category_ids` (verified absent). A detection of another category is
   ignored, neither a true nor a false positive.
2. Not-exhaustive images: for the categories in an image's
   `not_exhaustive_category_ids`, an unmatched detection is ignored (the
   annotators did not mark every instance).
3. At most `max_dets` (300) detections an image across categories (COCO caps
   100 a category), and AP is broken down by category frequency: APr (rare),
   APc (common), APf (frequent).

Polygons are rasterised by `native.polygons_to_mask` (pycocotools' rule, the
port's route for every polygon of ground truth).
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

from ..native import polygons_to_mask
from .coco_eval import CocoAPEvaluator


class LVISEvaluator:
    """The `process` / `evaluate` surface of `COCOEvaluator`; reads the LVIS
    json for each image's negative and not-exhaustive sets and each
    category's frequency."""

    def __init__(self, dataset_records: List[dict], json_file: str, max_dets: int = 300):
        self._gt_by_id = {r["image_id"]: r for r in dataset_records}
        self.max_dets = max_dets
        with open(json_file) as f:
            data = json.load(f)
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self._id_map = {c["id"]: i for i, c in enumerate(cats)}
        self._freq = {self._id_map[c["id"]]: c.get("frequency", "f") for c in cats}
        self._img_info = {
            img["id"]: {
                "neg": {self._id_map[c] for c in img.get("neg_category_ids", [])
                        if c in self._id_map},
                "not_exhaustive": {self._id_map[c]
                                   for c in img.get("not_exhaustive_category_ids", [])
                                   if c in self._id_map},
            }
            for img in data["images"]
        }
        self.reset()

    def reset(self) -> None:
        self._ap = CocoAPEvaluator("segm", max_dets=self.max_dets)

    def process(self, image_id, scores: np.ndarray, classes: np.ndarray,
                masks: Sequence[np.ndarray]) -> None:
        """Predictions at the image's original resolution, contiguous
        category ids."""
        rec = self._gt_by_id[image_id]
        h, w = rec["height"], rec["width"]
        gt_cats, gt_masks, gt_areas = [], [], []
        for a in rec.get("annotations", []):
            seg = a.get("segmentation")
            if not isinstance(seg, list):
                continue
            m = polygons_to_mask(seg, h, w)
            gt_cats.append(a["category_id"])
            gt_masks.append(m)
            gt_areas.append(a.get("area", m.sum()))

        info = self._img_info.get(image_id, {"neg": set(), "not_exhaustive": set()})
        eval_cats = set(gt_cats) | info["neg"]

        scores = np.asarray(scores)
        classes = np.asarray(classes)
        keep = scores > 0
        # at most max_dets an image across categories
        order = np.argsort(-scores[keep], kind="mergesort")[: self.max_dets]
        idx = np.nonzero(keep)[0][order]
        self._ap.add_image(
            det_scores=scores[idx],
            det_cats=classes[idx],
            det_masks_or_boxes=[masks[i] for i in idx],
            gt_cats=np.asarray(gt_cats, np.int64),
            gt_masks_or_boxes=gt_masks,
            gt_iscrowd=np.zeros(len(gt_cats), bool),  # LVIS has no crowd
            gt_areas=np.asarray(gt_areas, np.float64),
            eval_cats=eval_cats,
            ignore_unmatched_cats=info["not_exhaustive"],
        )

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        res = self._ap.summarize()
        per_cat = self._ap.per_category_ap()
        for key, freq in (("APr", "r"), ("APc", "c"), ("APf", "f")):
            vals = [ap for c, ap in per_cat.items()
                    if self._freq.get(c) == freq and not np.isnan(ap)]
            res[key] = float(np.mean(vals)) if vals else float("nan")
        return {"segm": res}
