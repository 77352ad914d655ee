"""Dataset evaluation: records through `Predictor` into an evaluator (d2's
inference_on_dataset; `mp_former_tpu/engine/eval_loop.py:inference_on_dataset`
for the instance task).

Each record is decoded, preprocessed on the device, run through the model and
post-processed in the reference's order by `Predictor`, one image at a time.
The JAX package's streamed and bucketed evaluation (`TPU.EVAL_STREAM`,
`TPU.EVAL_BUCKET_STEP`) and its mesh sharding amortise costs of the TPU runtime
and are not ported: the canvas is the resized image padded to a multiple of 32.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np

from .predictor import Predictor

logger = logging.getLogger(__name__)


def read_image(record: dict) -> Optional[np.ndarray]:
    """The record's image as an (H, W, 3) uint8 BGR array: the array under
    "image" where the record carries one, else the file under "file_name"
    decoded with cv2 (None if it cannot be read)."""
    if record.get("image") is not None:
        return record["image"]
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"decoding {record['file_name']!r} needs cv2, which is not installed; "
            "give the records their decoded BGR arrays under \"image\" instead") from e
    return cv2.imread(record["file_name"], cv2.IMREAD_COLOR)


def inference_on_dataset(cfg, predictor: Predictor, records: List[dict], evaluator,
                         max_images: Optional[int] = None) -> Dict:
    """Instance segmentation over `records` (at most `max_images` of them);
    returns the evaluator's summary. Predictions are made at the record's
    height and width (the image's own where the record has none)."""
    if not cfg.MODEL.MASK_FORMER.TEST.INSTANCE_ON:
        raise NotImplementedError("the port evaluates instance segmentation only so far")
    evaluator.reset()
    n = 0
    t0 = time.perf_counter()
    for rec in records:
        if max_images is not None and n >= max_images:
            break
        image = read_image(rec)
        if image is None:
            continue
        out_hw = (rec.get("height") or image.shape[0], rec.get("width") or image.shape[1])
        inst = predictor(image, out_hw)["instances"]
        evaluator.process(rec["image_id"], inst["scores"], inst["classes"], list(inst["masks"]))
        n += 1
        if n % 50 == 0:
            logger.info("eval %d images (%.2f s/img)", n, (time.perf_counter() - t0) / n)
    results = evaluator.evaluate()
    logger.info("evaluated %d images: %s", n, results)
    return results
