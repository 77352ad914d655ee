"""Dataset evaluation: records through `Predictor` into an evaluator (d2's
inference_on_dataset; `mp_former_tpu/engine/eval_loop.py:inference_on_dataset`
for the instance task), and `run_evaluation` of a registered dataset with the
evaluators its `evaluator_type` names (`Trainer.test` calls it).

Each record is decoded, preprocessed on the device, run through the model and
post-processed in the reference's order by `Predictor`, one image at a time.
The JAX package's streamed and bucketed evaluation (`TPU.EVAL_STREAM`,
`TPU.EVAL_BUCKET_STEP`) and its mesh sharding amortise costs of the TPU runtime
and are not ported: the canvas is the resized image padded to a multiple of 32.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .predictor import Predictor

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


def _predict(predictor: Predictor, records: List[dict],
             max_images: Optional[int] = None) -> Iterator[Tuple[dict, Dict]]:
    """(record, instances) for each readable record, at most `max_images`;
    predictions at the record's height and width (the image's own where the
    record has none)."""
    n = 0
    t0 = time.perf_counter()
    for rec in records:
        if max_images is not None and n >= max_images:
            break
        image = read_image(rec)
        if image is None:
            continue
        out_hw = (rec.get("height") or image.shape[0], rec.get("width") or image.shape[1])
        yield rec, predictor(image, out_hw)["instances"]
        n += 1
        if n % 50 == 0:
            logger.info("eval %d images (%.2f s/img)", n, (time.perf_counter() - t0) / n)


def inference_on_dataset(cfg, predictor: Predictor, records: List[dict], evaluator,
                         max_images: Optional[int] = None) -> Dict:
    """Instance segmentation over `records` (at most `max_images` of them);
    returns the evaluator's summary."""
    if not cfg.MODEL.MASK_FORMER.TEST.INSTANCE_ON:
        raise NotImplementedError("the port evaluates instance segmentation only so far")
    evaluator.reset()
    n = 0
    for rec, inst in _predict(predictor, records, max_images):
        evaluator.process(rec["image_id"], inst["scores"], inst["classes"], list(inst["masks"]))
        n += 1
    results = evaluator.evaluate()
    logger.info("evaluated %d images: %s", n, results)
    return results


def run_evaluation(cfg, model: torch.nn.Module, dataset_name: str,
                   max_images: Optional[int] = None) -> Dict:
    """Evaluate one registered dataset with its evaluator family (reference
    Trainer.test + build_evaluator, train_net.py:142-222;
    `mp_former_tpu/engine/eval_loop.py:run_evaluation`): one `Predictor`
    forward per image, on the model's own device. The tasks come from the
    evaluators, not from MASK_FORMER.TEST's switches. `max_images` caps the
    records, so an unreadable one shrinks the evaluated set, as in the JAX
    package."""
    from ..data.catalog import DatasetCatalog
    from ..evaluation.build import build_evaluator

    records = DatasetCatalog.get(dataset_name)
    evset = build_evaluator(cfg, dataset_name, records)
    if max_images is not None:
        records = records[:max_images]
    # the evaluators' one task so far, "instance", whatever INSTANCE_ON says
    pcfg = cfg.clone()
    pcfg.defrost()
    pcfg.MODEL.MASK_FORMER.TEST.INSTANCE_ON = True
    predictor = Predictor(pcfg, model=model, device=next(model.parameters()).device)
    evset.reset()
    n = 0
    t0 = time.perf_counter()
    for rec, inst in _predict(predictor, records):
        evset.process(rec, {"instance": (inst["scores"], inst["classes"], inst["masks"])})
        n += 1
    results = evset.evaluate()
    dt = time.perf_counter() - t0
    logger.info("evaluated %d images of %s in %.1f s (%.2f img/s): %s", n, dataset_name, dt,
                n / max(dt, 1e-9), results)
    return results
