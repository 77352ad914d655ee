"""COCOPanopticNewBaselineDatasetMapper, the LSJ mapper of the COCO panoptic
recipe (`INPUT.DATASET_MAPPER_NAME coco_panoptic_lsj`), after
`mp_former_tpu/data/dataset_mappers/mask_former_mappers.py:266-317`.

Per record: RandomFlip -> ResizeScale -> FixedSizeCrop on the image and,
with the same record, on the panoptic id map (nearest, padded with 0 = no
segment); each non-crowd segment of `segments_info` becomes one target, its
mask any-pooled to 1/stride of the canvas (`TPU.GT_MASK_STRIDE`), empty ones
dropped. The sample has the instance mapper's layout (`coco_instance_lsj`),
boxes zero as in the JAX package, so the loader and the criterion take it
unchanged.

No cv2 on the path: the image comes through `engine/eval_loop.py::read_image`
and the id map through `read_id_map`, both from `.npy` where the path ends so.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ...engine.eval_loop import read_image
from ...utils.registry import DATASET_MAPPER_REGISTRY
from ..transforms import (apply_record_to_image, apply_to_sem_seg, block_any_pool, lsj_transform,
                          resolve_gt_mask_stride)


def rgb2id(color: np.ndarray) -> np.ndarray:
    """COCO panoptic PNG encoding: id = R + 256 G + 256^2 B
    (`mask_former_mappers.py:24-27`)."""
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def read_id_map(path: str) -> Optional[np.ndarray]:
    """A panoptic id map as (H, W) int64 segment ids, 0 = no segment: a `.npy`
    file holds the ids themselves, (H, W) of an integer type (what
    `tools/make_synthetic_coco_torch.py --panoptic` writes); any other file is
    a COCO panoptic PNG decoded with cv2. None where the file cannot be read."""
    if path.endswith(".npy"):
        if not os.path.isfile(path):
            return None
        ids = np.load(path)
        if ids.ndim != 2 or not np.issubdtype(ids.dtype, np.integer):
            raise ValueError(f"{path}: expected (H, W) integer segment ids, got {ids.dtype} "
                             f"{ids.shape}")
        return ids.astype(np.int64)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"decoding {path!r} needs cv2, which is not installed; give the id maps as .npy "
            "files instead") from e
    pan = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if pan is None else rgb2id(pan[..., ::-1]).astype(np.int64)


@DATASET_MAPPER_REGISTRY.register(name="coco_panoptic_lsj")
class COCOPanopticNewBaselineDatasetMapper:
    def __init__(self, cfg, is_train: bool = True, max_instances: int = 100):
        self.is_train = is_train
        self.image_size = cfg.INPUT.IMAGE_SIZE
        self.min_scale = cfg.INPUT.MIN_SCALE
        self.max_scale = cfg.INPUT.MAX_SCALE
        self.flip = cfg.INPUT.RANDOM_FLIP != "none"
        self.img_format = cfg.INPUT.FORMAT
        self.max_instances = max_instances
        self.gt_mask_stride = resolve_gt_mask_stride(cfg)

    def __call__(self, record: Dict, rng: np.random.RandomState) -> Optional[Dict]:
        img = read_image(record)
        if img is None:
            return None
        if self.img_format == "RGB":
            img = img[:, :, ::-1]
        ids = read_id_map(record["pan_seg_file_name"])
        if ids is None:
            return None
        h, w = img.shape[:2]
        rec = lsj_transform(rng, h, w, self.image_size, self.min_scale, self.max_scale, self.flip)
        image = apply_record_to_image(img, rec, pad_value=128.0)
        ids = apply_to_sem_seg(ids, rec, 0)

        n_cap = self.max_instances
        s = self.gt_mask_stride
        ms = (self.image_size + s - 1) // s
        labels = np.zeros((n_cap,), np.int64)
        masks = np.zeros((n_cap, ms, ms), bool)
        valid = np.zeros((n_cap,), bool)
        idx = 0
        for seg in record.get("segments_info", []):
            if seg.get("iscrowd", 0) or idx >= n_cap:
                continue
            m = block_any_pool(ids == seg["id"], s)
            if not m.any():
                continue
            masks[idx, : m.shape[0], : m.shape[1]] = m
            labels[idx] = seg["category_id"]
            valid[idx] = True
            idx += 1
        return {
            "image": image,  # uint8, INPUT.FORMAT order; the model normalises
            "labels": labels,
            "masks": masks,
            "boxes": np.zeros((n_cap, 4), np.float32),
            "valid": valid,
            "image_id": record.get("image_id", -1),
            "height": record.get("height", h),
            "width": record.get("width", w),
        }
