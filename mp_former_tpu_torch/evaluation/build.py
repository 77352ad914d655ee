"""Evaluator factory keyed on a dataset's `evaluator_type` metadata (the
reference's Trainer.build_evaluator, train_net.py:142-222;
`mp_former_tpu/evaluation/build.py`), for the types the port evaluates:

| evaluator_type | evaluators                                             |
|----------------|--------------------------------------------------------|
| coco           | COCO instance (built whatever MASK_FORMER.TEST.INSTANCE_ON says, as the reference does) |

Every other type raises NotImplementedError: the semantic, panoptic,
Cityscapes and LVIS evaluators wait for a later slice of the port (ROADMAP
A16). One model forward serves every evaluator of a set: the evaluation loop
hands each evaluator the post-processed outputs of its task.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .coco_eval import COCOEvaluator


class _Entry:
    """One evaluator and the post-processed output family ("task") it consumes."""

    def __init__(self, task: str, evaluator):
        self.task = task
        self.evaluator = evaluator

    def process(self, record: dict, data) -> None:
        scores, classes, masks = data  # the only task so far: "instance"
        self.evaluator.process(record["image_id"], scores, classes,
                               [masks[i] for i in range(masks.shape[0])])


class EvaluatorSet:
    def __init__(self, entries: List[_Entry]):
        self.entries = entries

    def reset(self) -> None:
        for e in self.entries:
            e.evaluator.reset()

    def process(self, record: dict, task_outputs: Dict) -> None:
        for e in self.entries:
            if e.task in task_outputs:
                e.process(record, task_outputs[e.task])

    def evaluate(self) -> Dict:
        """The evaluators' task-keyed results merged ({'segm': ...})."""
        results = {}
        for e in self.entries:
            results.update(e.evaluator.evaluate())
        return results


def build_evaluator(cfg, dataset_name: str, records: Optional[List[dict]] = None) -> EvaluatorSet:
    """The evaluators of `dataset_name`'s `evaluator_type`; raises
    NotImplementedError for a type the port does not evaluate yet."""
    from ..data.catalog import DatasetCatalog, MetadataCatalog

    et = MetadataCatalog.get(dataset_name).get("evaluator_type")
    if et is None:
        raise NotImplementedError(f"no evaluator_type registered for dataset {dataset_name}")
    if et != "coco":
        raise NotImplementedError(
            f"the port has no evaluator for the dataset {dataset_name} of the type {et} yet "
            "(semantic, panoptic, Cityscapes and LVIS evaluation: ROADMAP A16)")
    if records is None:
        records = DatasetCatalog.get(dataset_name)
    # instance segmentation, not gated on INSTANCE_ON (reference train_net.py:164-166)
    return EvaluatorSet([_Entry("instance",
                                COCOEvaluator(records, max_dets=cfg.TEST.DETECTIONS_PER_IMAGE))])
