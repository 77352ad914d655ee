"""COCOInstanceNewBaselineDatasetMapper, the LSJ mapper of the released recipe
(`INPUT.DATASET_MAPPER_NAME coco_instance_lsj`), after
`mp_former_tpu/data/dataset_mappers/coco_instance_new_baseline.py`.

Per record: RandomFlip -> ResizeScale -> FixedSizeCrop on the image; crowd
annotations dropped; polygons transformed pointwise and rasterised at the
final canvas (at 1/stride of it, `TPU.GT_MASK_STRIDE`), uncompressed RLE
decoded, resized by nearest neighbour and any-pooled; empty masks dropped;
boxes from the masks. The output is padded to `max_instances` slots, as the
JAX package's, so that a batch is a few dense tensors.

No cv2: the image comes through `engine/eval_loop.py::read_image` (a `.npy`
file, the record's own array, or cv2 where installed), BGR -> RGB is a
channel flip, and the nearest resize of RLE masks is cv2's INTER_NEAREST
index rule in numpy (`transforms.resize_nearest`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...engine.eval_loop import read_image
from ...evaluation.coco_eval import rle_to_mask
from ...native import polygons_to_mask
from ...utils.boxes import box_xyxy_to_cxcywh, masks_to_boxes
from ...utils.registry import DATASET_MAPPER_REGISTRY
from ..transforms import (TransformRecord, apply_record_to_image, apply_to_sem_seg,
                          block_any_pool, lsj_transform, resolve_gt_mask_stride)


def _mask_from_segmentation(seg, rec: TransformRecord, stride: int = 1) -> Optional[np.ndarray]:
    """One annotation's segmentation transformed and rasterised at 1/stride
    of the output canvas (None for a format the mapper does not read)."""
    h = (rec.out_h + stride - 1) // stride
    w = (rec.out_w + stride - 1) // stride
    if isinstance(seg, list):  # polygons
        polys = []
        for p in seg:
            pts = rec.apply_coords(np.asarray(p, np.float64).reshape(-1, 2))
            polys.append((pts / stride).reshape(-1))
        return polygons_to_mask(polys, h, w)
    if isinstance(seg, dict) and isinstance(seg.get("counts"), list):  # uncompressed RLE
        m = apply_to_sem_seg(rle_to_mask(seg), rec, False)
        if stride > 1:
            m = block_any_pool(m, stride)[:h, :w]
        return m
    return None


@DATASET_MAPPER_REGISTRY.register(name="coco_instance_lsj")
class COCOInstanceNewBaselineDatasetMapper:
    def __init__(self, cfg, is_train: bool = True, max_instances: int = 100):
        self.is_train = is_train
        self.image_size = cfg.INPUT.IMAGE_SIZE
        self.min_scale = cfg.INPUT.MIN_SCALE
        self.max_scale = cfg.INPUT.MAX_SCALE
        self.flip = cfg.INPUT.RANDOM_FLIP != "none"
        self.max_instances = max_instances
        self.img_format = cfg.INPUT.FORMAT
        self.gt_mask_stride = resolve_gt_mask_stride(cfg)

    def __call__(self, record: Dict, rng: np.random.RandomState) -> Optional[Dict]:
        img = read_image(record)
        if img is None:
            return None
        if self.img_format == "RGB":
            img = img[:, :, ::-1]
        h, w = img.shape[:2]
        rec = lsj_transform(rng, h, w, self.image_size, self.min_scale, self.max_scale, self.flip)
        image = apply_record_to_image(img, rec, pad_value=128.0)

        n_cap = self.max_instances
        s = self.gt_mask_stride
        ms = (self.image_size + s - 1) // s
        labels = np.zeros((n_cap,), np.int64)
        masks = np.zeros((n_cap, ms, ms), bool)
        boxes = np.zeros((n_cap, 4), np.float32)
        valid = np.zeros((n_cap,), bool)
        if self.is_train:
            idx = 0
            for a in record.get("annotations", []):
                if a.get("iscrowd", 0) == 1:
                    continue
                if idx >= n_cap:
                    break
                m = _mask_from_segmentation(a.get("segmentation"), rec, s)
                if m is None or not m.any():
                    continue
                masks[idx] = m
                labels[idx] = a["category_id"]
                valid[idx] = True
                idx += 1
            # every kept mask is non-empty: its box ends one past its last pixel
            b = masks_to_boxes(torch.from_numpy(masks[:idx]))
            b[:, 2:] += 1
            # cxcywh normalised by the mask canvas (reference
            # maskformer_model.py:295): the normalisation cancels the stride
            boxes[:idx] = (box_xyxy_to_cxcywh(b) / ms).numpy()

        return {
            "image": image,  # uint8, INPUT.FORMAT order; the model normalises
            "labels": labels,
            "masks": masks,
            "boxes": boxes,
            "valid": valid,
            "image_id": record.get("image_id", -1),
            "height": record.get("height", h),
            "width": record.get("width", w),
        }
