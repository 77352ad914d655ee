"""Evaluator factory keyed on a dataset's `evaluator_type` metadata (the
reference's Trainer.build_evaluator, train_net.py:142-222;
`mp_former_tpu/evaluation/build.py`):

| evaluator_type                | evaluators (gated by MASK_FORMER.TEST.*)                                  |
|-------------------------------|---------------------------------------------------------------------------|
| sem_seg                       | SemSeg (not gated, as in the reference)                                   |
| coco                          | COCO instance (not gated on INSTANCE_ON, as in the reference)             |
| coco_panoptic_seg             | PQ (PANOPTIC_ON) + COCO instance (INSTANCE_ON) + SemSeg (SEMANTIC_ON, where the records carry `sem_seg_file_name`) |
| ade20k_panoptic_seg           | SemSeg (not gated) + PQ (PANOPTIC_ON) + InstanceSeg (INSTANCE_ON)         |
| mapillary_vistas_panoptic_seg | PQ (PANOPTIC_ON) + InstanceSeg (INSTANCE_ON) + SemSeg (SEMANTIC_ON, where the records carry ground truth) |
| cityscapes_instance           | CityscapesInstance (the official protocol)                                |
| cityscapes_sem_seg            | CityscapesSemSeg (IoU, iIoU)                                              |
| cityscapes_panoptic_seg       | PQ (PANOPTIC_ON) + CityscapesSemSeg (SEMANTIC_ON) + CityscapesInstance (INSTANCE_ON) |
| lvis                          | LVIS (federated AP, max(DETECTIONS_PER_IMAGE, 300) detections an image)    |

One model forward serves every evaluator of a set: `EvaluatorSet.tasks`
names the post-processings ("instance", "semantic", "panoptic") the
evaluation loop must produce. The Cityscapes evaluators take the record
(they read its `_gtFine` maps); the others an image id or a ground truth
map.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from ..data.dataset_mappers.mask_former_mappers import read_label_map
from .cityscapes_eval import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
from .coco_eval import COCOEvaluator
from .evaluators import COCOPanopticEvaluator, InstanceSegEvaluator, SemSegEvaluator
from .lvis_eval import LVISEvaluator

logger = logging.getLogger(__name__)


def _load_sem_seg_gt(record: dict) -> Optional[np.ndarray]:
    """The record's semantic ground truth, (H, W) class ids with the ignore
    label (`read_label_map`: `.npy` or a PNG's first channel); None without a
    path or a readable file."""
    return read_label_map(record.get("sem_seg_file_name"))


class _Entry:
    """One evaluator and the post-processed output family ("task") it consumes."""

    def __init__(self, task: str, evaluator):
        self.task = task
        self.evaluator = evaluator

    def process(self, record: dict, data) -> None:
        if self.task == "instance":
            scores, classes, masks = data
            masks = [masks[i] for i in range(masks.shape[0])]
            if isinstance(self.evaluator, CityscapesInstanceEvaluator):
                self.evaluator.process(record, scores, classes, masks)
            else:
                self.evaluator.process(record["image_id"], scores, classes, masks)
        elif self.task == "semantic":  # data: the (H, W) argmax over the classes
            if isinstance(self.evaluator, CityscapesSemSegEvaluator):
                self.evaluator.process(data, record)
                return
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

    def merge_from(self, other: "EvaluatorSet") -> None:
        """Fold in another rank's set, built from the same config: each
        evaluator merges its twin (`mp_former_tpu/evaluation/build.py:95-103`)."""
        if [(e.task, type(e.evaluator)) for e in self.entries] != \
                [(e.task, type(e.evaluator)) for e in other.entries]:
            raise ValueError("merge_from needs evaluator sets built from the same config")
        for mine, theirs in zip(self.entries, other.entries):
            mine.evaluator.merge_from(theirs.evaluator)

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


def cityscapes_thing_index(meta, num_classes: int) -> Optional[np.ndarray]:
    """The model's class -> contiguous Cityscapes thing index (-1: no thing)
    where the dataset's `thing_map` names the things among the model's
    classes (the panoptic registration's 19 trainIds); None where the
    classes are the thing indices already (the instance registration)."""
    thing_map = meta.get("thing_map")
    if not thing_map:
        return None
    index = np.full(num_classes, -1, np.int64)
    things = sorted(c for c, is_thing in thing_map.items() if is_thing and c < num_classes)
    index[things] = np.arange(len(things))
    return index


def build_evaluator(cfg, dataset_name: str, records: Optional[List[dict]] = None) -> EvaluatorSet:
    """The evaluators of `dataset_name`'s `evaluator_type`, in the JAX
    package's order (`mp_former_tpu/evaluation/build.py:134-224`); raises
    NotImplementedError for a dataset without an `evaluator_type`, or when
    the switches leave no evaluator."""
    from ..data.catalog import DatasetCatalog, MetadataCatalog

    meta = MetadataCatalog.get(dataset_name)
    et = meta.get("evaluator_type")
    if et is None:
        raise NotImplementedError(f"no evaluator_type registered for dataset {dataset_name}")
    if records is None:
        records = DatasetCatalog.get(dataset_name)
    test_cfg = cfg.MODEL.MASK_FORMER.TEST
    num_classes = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    ignore = meta.get("ignore_label", cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE)
    entries: List[_Entry] = []

    def sem(require_gt: bool = False):
        # the reference appends SemSegEvaluator unconditionally; a panoptic split
        # registered without semantic ground truth (coco_*_panoptic instead of
        # *_with_sem_seg) would score 0 images into a NaN mIoU: skip it instead
        if require_gt and records and not records[0].get("sem_seg_file_name"):
            logger.warning("%s has no sem_seg_file_name ground truth; skipping the semantic "
                           "evaluator (COCO's *_with_sem_seg registrations carry it)",
                           dataset_name)
            return
        entries.append(_Entry("semantic", SemSegEvaluator(num_classes, ignore)))

    def coco_inst(cls=COCOEvaluator):
        entries.append(_Entry("instance", cls(records, max_dets=cfg.TEST.DETECTIONS_PER_IMAGE)))

    def cityscapes_inst():
        entries.append(_Entry("instance", CityscapesInstanceEvaluator(
            thing_index=cityscapes_thing_index(meta, num_classes))))

    # semantic segmentation (reference :156-163, not gated on SEMANTIC_ON)
    if et in ("sem_seg", "ade20k_panoptic_seg"):
        sem()
    # instance segmentation (:164-166, not gated on INSTANCE_ON)
    if et == "coco":
        coco_inst()
    # panoptic segmentation (:167-177)
    if et in ("coco_panoptic_seg", "ade20k_panoptic_seg", "cityscapes_panoptic_seg",
              "mapillary_vistas_panoptic_seg") and test_cfg.PANOPTIC_ON:
        entries.append(_Entry("panoptic", COCOPanopticEvaluator(meta.get("thing_map", {}) or {})))
    # COCO panoptic extras (:178-182)
    if et == "coco_panoptic_seg" and test_cfg.INSTANCE_ON:
        coco_inst()
    if et == "coco_panoptic_seg" and test_cfg.SEMANTIC_ON:
        sem(require_gt=True)
    # Mapillary Vistas extras (:183-188)
    if et == "mapillary_vistas_panoptic_seg" and test_cfg.INSTANCE_ON:
        coco_inst(InstanceSegEvaluator)
    if et == "mapillary_vistas_panoptic_seg" and test_cfg.SEMANTIC_ON:
        sem(require_gt=True)
    # Cityscapes (:189-209)
    if et == "cityscapes_instance":
        cityscapes_inst()
    if et == "cityscapes_sem_seg":
        entries.append(_Entry("semantic", CityscapesSemSegEvaluator()))
    if et == "cityscapes_panoptic_seg":
        if test_cfg.SEMANTIC_ON:
            entries.append(_Entry("semantic", CityscapesSemSegEvaluator()))
        if test_cfg.INSTANCE_ON:
            cityscapes_inst()
    # ADE20K instance (:210-212)
    if et == "ade20k_panoptic_seg" and test_cfg.INSTANCE_ON:
        coco_inst(InstanceSegEvaluator)
    # LVIS (:214-215)
    if et == "lvis":
        entries.append(_Entry("instance", LVISEvaluator(
            records, meta.get("json_file"), max_dets=max(cfg.TEST.DETECTIONS_PER_IMAGE, 300))))
    if not entries:
        raise NotImplementedError(
            f"no evaluator for the dataset {dataset_name} of the type {et} with the enabled "
            "MASK_FORMER.TEST switches")
    return EvaluatorSet(entries)
