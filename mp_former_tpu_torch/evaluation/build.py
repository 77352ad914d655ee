"""Evaluator factory keyed on a dataset's `evaluator_type` metadata (the
reference's Trainer.build_evaluator, train_net.py:142-222;
`mp_former_tpu/evaluation/build.py`), for the types the port evaluates:

| evaluator_type    | evaluators (gated by MASK_FORMER.TEST.*)                       |
|-------------------|----------------------------------------------------------------|
| coco              | COCO instance (not gated on INSTANCE_ON, as in the reference)  |
| coco_panoptic_seg | PQ (PANOPTIC_ON) + COCO instance (INSTANCE_ON) + SemSeg (SEMANTIC_ON, where the records carry `sem_seg_file_name`) |

Every other type (sem_seg, ADE20K, Mapillary Vistas, Cityscapes, LVIS)
raises NotImplementedError: they wait for a later slice of the port (ROADMAP
A16b). One model forward serves every evaluator of a set: `EvaluatorSet.tasks`
names the post-processings ("instance", "semantic", "panoptic") the
evaluation loop must produce.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from .coco_eval import COCOEvaluator
from .evaluators import COCOPanopticEvaluator, SemSegEvaluator

logger = logging.getLogger(__name__)


def _load_sem_seg_gt(record: dict) -> Optional[np.ndarray]:
    """The record's semantic ground truth, (H, W) class ids with the ignore
    label: `np.load` where the path ends in `.npy`, else decoded with cv2
    (the first channel of a colour PNG); None without a path or a readable
    file."""
    path = record.get("sem_seg_file_name")
    if not path:
        return None
    if path.endswith(".npy"):
        return np.load(path) if os.path.isfile(path) else None
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"decoding {path!r} needs cv2, which is not installed; give the "
                          "semantic maps as .npy files instead") from e
    gt = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if gt is None:
        return None
    return gt[..., 0] if gt.ndim == 3 else gt


class _Entry:
    """One evaluator and the post-processed output family ("task") it consumes."""

    def __init__(self, task: str, evaluator):
        self.task = task
        self.evaluator = evaluator

    def process(self, record: dict, data) -> None:
        if self.task == "instance":
            scores, classes, masks = data
            self.evaluator.process(record["image_id"], scores, classes,
                                   [masks[i] for i in range(masks.shape[0])])
        elif self.task == "semantic":  # data: the (H, W) argmax over the classes
            gt = _load_sem_seg_gt(record)
            if gt is None:
                logger.warning("no sem_seg ground truth for image %s; skipped",
                               record.get("image_id"))
                return
            self.evaluator.process(data, gt)
        else:  # panoptic
            pan_map, segments = data
            self.evaluator.process_prediction(record, pan_map, segments)


class EvaluatorSet:
    def __init__(self, entries: List[_Entry]):
        self.entries = entries

    @property
    def tasks(self) -> List[str]:
        return sorted({e.task for e in self.entries})

    def reset(self) -> None:
        for e in self.entries:
            e.evaluator.reset()

    def process(self, record: dict, task_outputs: Dict) -> None:
        for e in self.entries:
            if e.task in task_outputs:
                e.process(record, task_outputs[e.task])

    def evaluate(self) -> Dict:
        """The evaluators' task-keyed results merged ({'segm': ...},
        {'sem_seg': ...}, {'panoptic_seg': ...})."""
        results = {}
        for e in self.entries:
            results.update(e.evaluator.evaluate())
        return results


def is_thing_array(cfg, meta) -> np.ndarray:
    """(NUM_CLASSES,) bool: the metadata's `thing_map` (contiguous id ->
    isthing), a class it does not name counted as a thing
    (`mp_former_tpu/evaluation/build.py:127-130`)."""
    thing_map = meta.get("thing_map", {}) or {}
    return np.array([thing_map.get(i, True) for i in range(cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)])


def build_evaluator(cfg, dataset_name: str, records: Optional[List[dict]] = None) -> EvaluatorSet:
    """The evaluators of `dataset_name`'s `evaluator_type`; raises
    NotImplementedError for a type the port does not evaluate yet, or when
    the switches leave no evaluator."""
    from ..data.catalog import DatasetCatalog, MetadataCatalog

    meta = MetadataCatalog.get(dataset_name)
    et = meta.get("evaluator_type")
    if et is None:
        raise NotImplementedError(f"no evaluator_type registered for dataset {dataset_name}")
    if et not in ("coco", "coco_panoptic_seg"):
        raise NotImplementedError(
            f"the port has no evaluator for the dataset {dataset_name} of the type {et} yet "
            "(semantic, ADE20K, Mapillary Vistas, Cityscapes and LVIS evaluation: ROADMAP A16b)")
    if records is None:
        records = DatasetCatalog.get(dataset_name)
    test_cfg = cfg.MODEL.MASK_FORMER.TEST

    def coco_instance():
        return _Entry("instance", COCOEvaluator(records, max_dets=cfg.TEST.DETECTIONS_PER_IMAGE))

    if et == "coco":
        # instance segmentation, not gated on INSTANCE_ON (reference train_net.py:164-166)
        return EvaluatorSet([coco_instance()])
    entries = []
    if test_cfg.PANOPTIC_ON:  # reference :167-177
        entries.append(_Entry("panoptic", COCOPanopticEvaluator(meta.get("thing_map", {}) or {})))
    if test_cfg.INSTANCE_ON:  # :178-182
        entries.append(coco_instance())
    if test_cfg.SEMANTIC_ON:
        # the reference appends SemSegEvaluator unconditionally; a panoptic split
        # registered without semantic ground truth (coco_*_panoptic instead of
        # *_with_sem_seg) would score 0 images into a NaN mIoU: skip it instead
        if records and not records[0].get("sem_seg_file_name"):
            logger.warning("%s has no sem_seg_file_name ground truth; skipping the semantic "
                           "evaluator (use the *_with_sem_seg registration for mIoU)",
                           dataset_name)
        else:
            ignore = meta.get("ignore_label", cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE)
            entries.append(_Entry("semantic", SemSegEvaluator(
                cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, ignore)))
    if not entries:
        raise NotImplementedError(
            f"no evaluator for the dataset {dataset_name} of the type {et} with the enabled "
            "MASK_FORMER.TEST switches")
    return EvaluatorSet(entries)
