"""The panoptic and semantic evaluators of the d2 protocol (reset / process /
evaluate), after `mp_former_tpu/evaluation/evaluators.py:79-158`:

- `COCOPanopticEvaluator`: PQ (`panoptic_eval.PanopticEvaluator`) against the
  record's panoptic id map, read from `.npy` or PNG (`read_id_map`); a
  prediction of another size is resized to the ground truth's by cv2's
  INTER_NEAREST rule (`data/transforms.py:resize_nearest`).
- `SemSegEvaluator`: mIoU, fwIoU, mACC and pACC from a (K+1)^2 confusion
  matrix, the ignore label counted in the extra row and column (d2's
  SemSegEvaluator).

The instance evaluator is `coco_eval.COCOEvaluator`; `InstanceSegEvaluator`,
which ADE20K and Mapillary Vistas panoptic evaluation name, is the same class,
as in the JAX package (`mp_former_tpu/evaluation/evaluators.py:76`): the
reference's only relaxes the contiguous-id checks of d2's
(instance_evaluation.py:29-107), and ids are arbitrary here already.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..data.dataset_mappers.coco_panoptic_new_baseline import read_id_map
from ..data.transforms import resize_nearest
from .coco_eval import COCOEvaluator
from .panoptic_eval import PanopticEvaluator

InstanceSegEvaluator = COCOEvaluator


class COCOPanopticEvaluator:
    """PQ against the panoptic ground truth of the records (d2's
    COCOPanopticEvaluator role; `is_thing`: the dataset's `thing_map`, which
    splits the result into Things and Stuff)."""

    def __init__(self, is_thing: Optional[Dict[int, bool]] = None):
        self._pq = PanopticEvaluator(is_thing)

    def reset(self) -> None:
        self._pq.reset()

    def merge_from(self, other: "COCOPanopticEvaluator") -> None:
        self._pq.merge_from(other._pq)

    def process_prediction(self, record: dict, pred_map: np.ndarray,
                           pred_segments: List[dict]) -> None:
        gt_map = read_id_map(record["pan_seg_file_name"])
        if gt_map is None:
            raise FileNotFoundError(f"panoptic ground truth {record['pan_seg_file_name']} "
                                    "cannot be read")
        if gt_map.shape != pred_map.shape:
            pred_map = resize_nearest(pred_map.astype(np.int32), *gt_map.shape)
        self._pq.process(pred_map, pred_segments, gt_map, record["segments_info"])

    def evaluate(self) -> Dict:
        return self._pq.evaluate()


class SemSegEvaluator:
    """d2's SemSegEvaluator: an (N+1) x (N+1) confusion matrix, the ignore
    label in the last column."""

    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.reset()

    def reset(self) -> None:
        self._conf = np.zeros((self.num_classes + 1, self.num_classes + 1), np.int64)

    def merge_from(self, other: "SemSegEvaluator") -> None:
        self._conf += other._conf

    def process(self, pred: np.ndarray, gt: np.ndarray) -> None:
        """pred (H, W) class ids; gt (H, W) class ids with the ignore label."""
        pred = pred.astype(np.int64)
        gt = gt.astype(np.int64).copy()
        gt[gt == self.ignore_label] = self.num_classes
        self._conf += np.bincount(
            (self.num_classes + 1) * pred.reshape(-1) + gt.reshape(-1),
            minlength=self._conf.size).reshape(self._conf.shape)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        acc = np.full(self.num_classes, np.nan)
        iou = np.full(self.num_classes, np.nan)
        tp = self._conf.diagonal()[:-1].astype(np.float64)
        pos_gt = self._conf[:-1, :-1].sum(0).astype(np.float64)
        # the ignore column is left out (d2 sums conf[:-1, :-1]): predictions over
        # ignored pixels neither inflate a union nor deflate an IoU
        pos_pred = self._conf[:-1, :-1].sum(1).astype(np.float64)
        class_weights = pos_gt / max(pos_gt.sum(), 1)
        valid = pos_gt > 0
        acc[valid] = tp[valid] / pos_gt[valid]
        union = pos_gt + pos_pred - tp
        iou_valid = np.logical_and(valid, union > 0)
        iou[iou_valid] = tp[iou_valid] / union[iou_valid]
        miou = float(np.nanmean(iou[valid])) if valid.any() else float("nan")
        fiou = float((iou[iou_valid] * class_weights[iou_valid]).sum())
        pacc = float(tp.sum() / max(pos_gt.sum(), 1))
        macc = float(np.nanmean(acc[valid])) if valid.any() else float("nan")
        return {"sem_seg": {"mIoU": 100 * miou, "fwIoU": 100 * fiou,
                            "mACC": 100 * macc, "pACC": 100 * pacc}}
