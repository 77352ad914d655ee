"""The MaskFormer semantic, panoptic and instance dataset mappers of the
ADE20K, Cityscapes and Mapillary Vistas recipes (`INPUT.DATASET_MAPPER_NAME`
`mask_former_semantic`, `mask_former_panoptic`, `mask_former_instance`), after
`mp_former_tpu/data/dataset_mappers/mask_former_mappers.py:42-264` (reference
mask_former_{semantic,panoptic,instance}_dataset_mapper.py).

Per record: ResizeShortestEdge (MIN_SIZE_TRAIN, "choice" or "range", long
side capped at MAX_SIZE_TRAIN, with a flip) -> the crop of INPUT.CROP
(absolute or relative; with SINGLE_CATEGORY_MAX_AREA < 1 it is drawn again,
up to 10 times, while one class covers more than that share of it) ->
ColorAugSSD (COLOR_AUG_SSD) on the image; the same geometry on the semantic
map (padded with the ignore label), the panoptic id map (padded with 0) or
the polygons. The image is padded with 128, the maps likewise, to one static
canvas: the crop size rounded up to max(SIZE_DIVISIBILITY, 32), so that the
loader's batches keep one shape. Targets: one per class present on the full
canvas (semantic), per non-crowd segment (panoptic) or per non-crowd
annotation (instance), masks any-pooled to 1/TPU.GT_MASK_STRIDE of the
canvas, empty ones dropped; the sample has the layout `data/loader.py`
collates (boxes zero, as in the JAX package); the semantic mapper also
carries the canvas's semantic map under "sem_seg", which is not collated.

The draws from the `np.random.RandomState` are the JAX package's, in its
order. No cv2 on the path: images through `engine/eval_loop.py::read_image`,
id maps through `read_id_map`, semantic maps through `read_label_map`, each
from `.npy` where the path ends so; polygons through `native/maskapi.cc`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ...engine.eval_loop import read_image
from ...utils.registry import DATASET_MAPPER_REGISTRY
from ..transforms import (TransformRecord, apply_record_to_image, apply_to_sem_seg,
                          block_any_pool, color_aug_ssd, resize_shortest_edge,
                          resolve_gt_mask_stride)
from .coco_instance_new_baseline import _mask_from_segmentation
from .coco_panoptic_new_baseline import read_id_map


def read_label_map(path: Optional[str]) -> Optional[np.ndarray]:
    """An (H, W) integer map as stored (semantic classes with the ignore
    label, Cityscapes `labelIds` or `instanceIds`): `np.load` where the path
    ends in `.npy`, else cv2's IMREAD_UNCHANGED, the first channel of a
    colour PNG; None without a path or a readable file."""
    if not path:
        return None
    if path.endswith(".npy"):
        if not os.path.isfile(path):
            return None
        m = np.load(path)
        if m.ndim != 2 or not np.issubdtype(m.dtype, np.integer):
            raise ValueError(f"{path}: expected an (H, W) integer map, got {m.dtype} {m.shape}")
        return m
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"decoding {path!r} needs cv2, which is not installed; give the "
                          "maps as .npy files instead") from e
    m = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if m is None:
        return None
    return m[..., 0] if m.ndim == 3 else m


def _random_crop_record(rng: np.random.RandomState, rec: TransformRecord, crop_hw,
                        sem: Optional[np.ndarray] = None, single_category_max_area: float = 1.0,
                        ignore: int = 255, retries: int = 10) -> TransformRecord:
    """d2 RandomCrop (with _CategoryAreaConstraint where `sem` is given and
    the limit is below 1): an absolute crop of the resized image, drawn
    again up to `retries` times while one class covers `single_category_max_
    area` of the crop's labelled pixels or fewer than two classes lie in it
    (`mask_former_mappers.py:42-66`)."""
    ch, cw = crop_hw
    h, w = rec.out_h, rec.out_w
    ch, cw = min(ch, h), min(cw, w)
    for _ in range(retries):
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        if sem is None or single_category_max_area >= 1.0:
            break
        labels, cnt = np.unique(sem[y0:y0 + ch, x0:x0 + cw], return_counts=True)
        cnt = cnt[labels != ignore]
        if len(cnt) > 1 and cnt.max() < single_category_max_area * cnt.sum():
            break
    return TransformRecord(
        flip=rec.flip, src_w=rec.src_w, scale_x=rec.scale_x, scale_y=rec.scale_y,
        tx=rec.tx - x0, ty=rec.ty - y0, out_h=ch, out_w=cw)


class _BaseSemanticMapper:
    """The geometry and canvas the three mappers share
    (`mask_former_mappers.py:69-120`)."""

    def __init__(self, cfg, is_train: bool = True, max_instances: int = 100):
        self.is_train = is_train
        self.min_sizes = list(cfg.INPUT.MIN_SIZE_TRAIN)
        self.sampling = cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING
        self.max_size = cfg.INPUT.MAX_SIZE_TRAIN
        self.crop_enabled = cfg.INPUT.CROP.ENABLED
        self.crop_type = cfg.INPUT.CROP.TYPE
        self.crop_size = list(cfg.INPUT.CROP.SIZE)
        self.single_cat_max = cfg.INPUT.CROP.SINGLE_CATEGORY_MAX_AREA
        self.color_aug = cfg.INPUT.COLOR_AUG_SSD
        self.ignore = cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE
        self.size_div = max(cfg.INPUT.SIZE_DIVISIBILITY, 32)
        self.img_format = cfg.INPUT.FORMAT
        self.max_instances = max_instances
        self.gt_mask_stride = resolve_gt_mask_stride(cfg)

    def _geometry(self, rng: np.random.RandomState, h: int, w: int,
                  sem: Optional[np.ndarray] = None) -> TransformRecord:
        rec = resize_shortest_edge(rng, h, w, self.min_sizes, self.max_size, self.sampling,
                                   flip=True)
        if self.crop_enabled and self.is_train:
            if self.crop_type == "absolute":
                crop_hw = (int(self.crop_size[0]), int(self.crop_size[1]))
            else:  # relative / relative_range
                f = rng.uniform(self.crop_size[0], self.crop_size[-1])
                crop_hw = (int(rec.out_h * f + 0.5), int(rec.out_w * f + 0.5))
            sem_resized = None
            if sem is not None and self.single_cat_max < 1.0:
                sem_resized = apply_to_sem_seg(sem, rec, self.ignore)
            rec = _random_crop_record(rng, rec, crop_hw, sem_resized, self.single_cat_max,
                                      self.ignore)
        return rec

    def _canvas(self, rec: TransformRecord):
        """The padded canvas (h, w): the transformed size rounded up to the
        size divisor, and in training with an absolute crop at least the crop
        size rounded up, one shape for every sample (multi-scale resizing
        makes min(crop, resized) vary, and mixed shapes cannot share a batch)."""
        d = self.size_div
        h = (rec.out_h + d - 1) // d * d
        w = (rec.out_w + d - 1) // d * d
        if self.is_train and self.crop_enabled and self.crop_type == "absolute":
            h = max(h, (int(self.crop_size[0]) + d - 1) // d * d)
            w = max(w, (int(self.crop_size[1]) + d - 1) // d * d)
        return h, w

    def _load_image(self, record: Dict) -> Optional[np.ndarray]:
        img = read_image(record)
        if img is not None and self.img_format == "RGB":
            img = np.ascontiguousarray(img[:, :, ::-1])
        return img

    def _image_canvas(self, img: np.ndarray, rec: TransformRecord,
                      rng: np.random.RandomState) -> np.ndarray:
        """ColorAugSSD (in training), the geometry, and the padded canvas."""
        if self.color_aug and self.is_train:
            img = color_aug_ssd(rng, img)
        image = apply_record_to_image(img, rec, pad_value=128.0)
        ph, pw = self._canvas(rec)
        canvas = np.full((ph, pw, 3), 128, np.uint8)
        canvas[: image.shape[0], : image.shape[1]] = image
        return canvas

    def _sample(self, record: Dict, canvas: np.ndarray, labels, masks, valid, h: int,
                w: int) -> Dict:
        return {
            "image": canvas,  # uint8, INPUT.FORMAT order; the model normalises
            "labels": labels,
            "masks": masks,
            "boxes": np.zeros((self.max_instances, 4), np.float32),
            "valid": valid,
            "image_id": record.get("image_id", -1),
            "height": record.get("height") or h,
            "width": record.get("width") or w,
        }

    def _slots(self, mask_shape):
        n = self.max_instances
        return (np.zeros((n,), np.int64), np.zeros((n,) + tuple(mask_shape), bool),
                np.zeros((n,), bool))


@DATASET_MAPPER_REGISTRY.register(name="mask_former_semantic")
class MaskFormerSemanticDatasetMapper(_BaseSemanticMapper):
    """One target per class present on the canvas's semantic map
    (`mask_former_mappers.py:122-166`)."""

    def __call__(self, record: Dict, rng: np.random.RandomState) -> Optional[Dict]:
        img = self._load_image(record)
        if img is None:
            return None
        sem = read_label_map(record["sem_seg_file_name"])
        if sem is None:
            return None
        h, w = img.shape[:2]
        rec = self._geometry(rng, h, w, sem)
        canvas = self._image_canvas(img, rec, rng)
        sem_t = apply_to_sem_seg(sem, rec, self.ignore)
        sem_canvas = np.full(canvas.shape[:2], self.ignore, sem_t.dtype)
        sem_canvas[: sem_t.shape[0], : sem_t.shape[1]] = sem_t

        st = self.gt_mask_stride
        # class presence from the full canvas, masks any-pooled: point sampling
        # ([::st]) could drop thin classes (poles, lines)
        labels, masks, valid = self._slots(((sem_canvas.shape[0] + st - 1) // st,
                                            (sem_canvas.shape[1] + st - 1) // st))
        classes = np.unique(sem_canvas)
        classes = classes[classes != self.ignore]
        for i, c in enumerate(classes[: self.max_instances]):
            masks[i] = block_any_pool(sem_canvas == c, st)
            labels[i] = c
            valid[i] = True
        out = self._sample(record, canvas, labels, masks, valid, h, w)
        out["sem_seg"] = sem_canvas.astype(np.int32)
        return out


@DATASET_MAPPER_REGISTRY.register(name="mask_former_panoptic")
class MaskFormerPanopticDatasetMapper(_BaseSemanticMapper):
    """One target per non-crowd segment of `segments_info`, from the
    panoptic id map (`mask_former_mappers.py:169-218`)."""

    def __call__(self, record: Dict, rng: np.random.RandomState) -> Optional[Dict]:
        img = self._load_image(record)
        if img is None:
            return None
        ids = read_id_map(record["pan_seg_file_name"])
        if ids is None:
            return None
        h, w = img.shape[:2]
        rec = self._geometry(rng, h, w)
        canvas = self._image_canvas(img, rec, rng)
        pan_t = apply_to_sem_seg(ids, rec, 0)
        pan_canvas = np.zeros(canvas.shape[:2], np.int64)
        pan_canvas[: pan_t.shape[0], : pan_t.shape[1]] = pan_t

        st = self.gt_mask_stride
        labels, masks, valid = self._slots(((pan_canvas.shape[0] + st - 1) // st,
                                            (pan_canvas.shape[1] + st - 1) // st))
        i = 0
        for seg in record.get("segments_info", []):
            if seg.get("iscrowd", 0) or i >= self.max_instances:
                continue
            m = block_any_pool(pan_canvas == seg["id"], st)
            if not m.any():
                continue
            masks[i] = m
            labels[i] = seg["category_id"]
            valid[i] = True
            i += 1
        return self._sample(record, canvas, labels, masks, valid, h, w)


@DATASET_MAPPER_REGISTRY.register(name="mask_former_instance")
class MaskFormerInstanceDatasetMapper(_BaseSemanticMapper):
    """One target per non-crowd annotation, polygons (or uncompressed RLE)
    transformed and rasterised at 1/stride of the crop
    (`mask_former_mappers.py:221-264`)."""

    def __call__(self, record: Dict, rng: np.random.RandomState) -> Optional[Dict]:
        img = self._load_image(record)
        if img is None:
            return None
        h, w = img.shape[:2]
        rec = self._geometry(rng, h, w)
        canvas = self._image_canvas(img, rec, rng)

        st = self.gt_mask_stride
        mh, mw = (canvas.shape[0] + st - 1) // st, (canvas.shape[1] + st - 1) // st
        labels, masks, valid = self._slots((mh, mw))
        i = 0
        for a in record.get("annotations", []):
            if a.get("iscrowd", 0) or i >= self.max_instances:
                continue
            m = _mask_from_segmentation(a.get("segmentation"), rec, st)
            if m is None or not m.any():
                continue
            masks[i, : m.shape[0], : m.shape[1]] = m
            labels[i] = a["category_id"]
            valid[i] = True
            i += 1
        return self._sample(record, canvas, labels, masks, valid, h, w)
