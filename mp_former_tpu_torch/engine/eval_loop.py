"""Dataset evaluation: records through `Predictor` into an evaluator (d2's
inference_on_dataset; `mp_former_tpu/engine/eval_loop.py:inference_on_dataset`,
one task), and `run_evaluation` of a registered dataset with the evaluators
its `evaluator_type` names (`Trainer.test` calls it).

Each record is decoded, preprocessed on the device, run through the model
once and post-processed in the reference's order by `Predictor` for every task
its evaluators ask for (instance, semantic, panoptic), one image at a time.
The JAX package's streamed and bucketed evaluation (`TPU.EVAL_STREAM`,
`TPU.EVAL_BUCKET_STEP`) and its mesh of devices within a process amortise
costs of the TPU runtime and are not ported: the canvas is the resized image
padded to a multiple of 32. Across data-parallel ranks `run_evaluation`
shards the records and merges the evaluators (`parallel/dist.py:
sharded_eval_loop`), and every rank returns the results of the whole set.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.dist import sharded_eval_loop
from .predictor import TASK_KEYS, Predictor

logger = logging.getLogger(__name__)


def read_image(record: dict) -> Optional[np.ndarray]:
    """The record's image as an (H, W, 3) uint8 BGR array: the array under
    "image" where the record carries one; else the file under "file_name",
    by `np.load` where it ends in `.npy` (how images reach a machine without
    an image decoder), else decoded with cv2 (None if it cannot be read)."""
    if record.get("image") is not None:
        return record["image"]
    path = record["file_name"]
    if path.endswith(".npy"):
        if not os.path.isfile(path):
            return None
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{path}: expected an (H, W, 3) uint8 BGR array, "
                             f"got {img.dtype} {img.shape}")
        return img
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"decoding {path!r} needs cv2, which is not installed; give the records "
            "their decoded BGR arrays under \"image\" or as .npy files instead") from e
    return cv2.imread(path, cv2.IMREAD_COLOR)


def _predict(predictor: Predictor, records: List[dict], tasks: Sequence[str],
             max_images: Optional[int] = None) -> Iterator[Tuple[dict, Dict]]:
    """(record, the predictor's outputs of `tasks`) for each readable record,
    at most `max_images`; predictions at the record's height and width (the
    image's own where the record has none), "sem_seg" as the argmax labels."""
    n = 0
    t0 = time.perf_counter()
    for rec in records:
        if max_images is not None and n >= max_images:
            break
        image = read_image(rec)
        if image is None:
            continue
        out_hw = (rec.get("height") or image.shape[0], rec.get("width") or image.shape[1])
        yield rec, predictor(image, out_hw, tasks=tasks, sem_seg_labels=True)
        n += 1
        if n % 50 == 0:
            logger.info("eval %d images (%.2f s/img)", n, (time.perf_counter() - t0) / n)


def inference_on_dataset(cfg, predictor: Predictor, records: List[dict], evaluator,
                         max_images: Optional[int] = None, task: str = "instance",
                         is_thing: Optional[np.ndarray] = None,
                         sem_seg_loader: Optional[Callable[[dict], np.ndarray]] = None) -> Dict:
    """One task over `records` (at most `max_images` of them) into one
    evaluator; returns its summary. task: "instance" (`evaluator.process(
    image_id, scores, classes, masks)`), "semantic" (`evaluator.process(pred,
    gt)` with `sem_seg_loader(record) -> (H, W)` ground truth) or "panoptic"
    (`evaluator.process_prediction(record, id_map, segments)`, the thing
    classes `is_thing`, by default the predictor's)."""
    if task == "semantic" and sem_seg_loader is None:
        raise ValueError("inference_on_dataset(task='semantic') needs a sem_seg_loader")
    if is_thing is not None:
        predictor = copy.copy(predictor)
        predictor.is_thing = np.asarray(is_thing, bool)
    evaluator.reset()
    n = 0
    for rec, out in _predict(predictor, records, [task], max_images):
        if task == "instance":
            inst = out["instances"]
            evaluator.process(rec["image_id"], inst["scores"], inst["classes"],
                              list(inst["masks"]))
        elif task == "semantic":
            evaluator.process(out["sem_seg"], sem_seg_loader(rec))
        else:
            evaluator.process_prediction(rec, *out["panoptic_seg"])
        n += 1
    results = evaluator.evaluate()
    logger.info("evaluated %d images: %s", n, results)
    return results


def run_evaluation(cfg, model: torch.nn.Module, dataset_name: str,
                   max_images: Optional[int] = None) -> Dict:
    """Evaluate one registered dataset with its evaluator family (reference
    Trainer.test + build_evaluator, train_net.py:142-222;
    `mp_former_tpu/engine/eval_loop.py:run_evaluation`): one `Predictor`
    forward per image, on the model's own device, post-processed for every
    task of the evaluators (`EvaluatorSet.tasks`), with the dataset's thing
    classes for the panoptic fusion. `max_images` caps the records, so an
    unreadable one shrinks the evaluated set, as in the JAX package. Across
    data-parallel ranks each takes its share of the records and every rank
    returns the merged results (`sharded_eval_loop`). The `Predictor` puts
    the model in `.eval()` mode (`Trainer.test` restores its own)."""
    from ..data.catalog import DatasetCatalog, MetadataCatalog
    from ..evaluation.build import build_evaluator, is_thing_array

    records = DatasetCatalog.get(dataset_name)
    evset = build_evaluator(cfg, dataset_name, records)
    predictor = Predictor(cfg, model=model, device=next(model.parameters()).device,
                          is_thing=is_thing_array(cfg, MetadataCatalog.get(dataset_name)))
    tasks = evset.tasks
    evset.reset()

    def read(rec: dict) -> Optional[Tuple[dict, np.ndarray]]:
        image = read_image(rec)
        return None if image is None else (rec, image)

    def process(item: Tuple[dict, np.ndarray]) -> None:
        rec, image = item
        out_hw = (rec.get("height") or image.shape[0], rec.get("width") or image.shape[1])
        out = predictor(image, out_hw, tasks=tasks, sem_seg_labels=True)
        outputs = {t: out[TASK_KEYS[t]] for t in tasks}
        if "instance" in outputs:
            inst = outputs["instance"]
            outputs["instance"] = (inst["scores"], inst["classes"], inst["masks"])
        evset.process(rec, outputs)

    t0 = time.perf_counter()
    n = sharded_eval_loop(records, evset, read, process, max_records=max_images)
    results = evset.evaluate()
    dt = time.perf_counter() - t0
    logger.info("evaluated %d images of %s (%s) in %.1f s (%.2f img/s): %s", n, dataset_name,
                ", ".join(tasks), dt, n / max(dt, 1e-9), results)
    return results
