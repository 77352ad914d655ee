"""Host-side augmentations (the port's copy of `mp_former_tpu/data/
transforms.py`), as d2's transforms the reference uses:

- the LSJ recipe (`coco_instance_lsj`, `coco_panoptic_lsj`): RandomFlip ->
  ResizeScale(MIN_SCALE..MAX_SCALE of IMAGE_SIZE) -> FixedSizeCrop
  (IMAGE_SIZE^2, padded with 128);
- the semantic recipe (`mask_former_semantic`, `_panoptic`, `_instance`):
  ResizeShortestEdge (+ flip), the crops of `dataset_mappers/
  mask_former_mappers.py`, ColorAugSSD.

A transform is drawn as a `TransformRecord`, which re-applies the geometric
map to coordinates, polygons, masks and the image. The draws from the
`np.random.RandomState` are the JAX package's, in its order, so the same
state gives the same record. The image is resized with `F.interpolate`
(bilinear, half-pixel centres, as cv2's INTER_LINEAR) on the CPU and rounded
to uint8; cv2 computes uint8 in fixed point, so a pixel may differ from the
JAX package's by a grey level. Polygons are rasterised by
`native.polygons_to_mask` (pycocotools' rule, the JAX package's native route).
Integer maps (masks, panoptic id maps, semantic maps) are resized by
`resize_nearest`, cv2's INTER_NEAREST index rule in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class TransformRecord:
    """Composable geometric transform: x' = sx*x + tx (after optional hflip),
    y' = sy*y + ty, with final canvas size (h, w)."""

    flip: bool
    src_w: int           # width at the time of the flip
    scale_x: float
    scale_y: float
    tx: float
    ty: float
    out_h: int
    out_w: int

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        """coords: (..., 2) float (x, y)."""
        c = coords.astype(np.float64).copy()
        if self.flip:
            c[..., 0] = self.src_w - c[..., 0]
        c[..., 0] = c[..., 0] * self.scale_x + self.tx
        c[..., 1] = c[..., 1] * self.scale_y + self.ty
        return c


def resize_uint8(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W, C) uint8 tensor on any device -> (h, w, C) uint8 on the same
    device, bilinear with half-pixel centres (cv2's INTER_LINEAR), rounded."""
    x = img.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    return x.round_().clamp_(0, 255)[0].permute(1, 2, 0).to(torch.uint8)


def _resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8, bilinear with half-pixel centres."""
    return resize_uint8(torch.from_numpy(np.ascontiguousarray(img)), h, w).numpy()


def random_flip(rng: np.random.RandomState, enabled: bool = True, prob: float = 0.5):
    return bool(enabled and rng.rand() < prob)


def lsj_transform(
    rng: np.random.RandomState,
    img_h: int,
    img_w: int,
    image_size: int = 1024,
    min_scale: float = 0.1,
    max_scale: float = 2.0,
    flip: bool = True,
) -> TransformRecord:
    """Geometry of RandomFlip + ResizeScale + FixedSizeCrop (d2 semantics)."""
    do_flip = random_flip(rng, flip)
    # d2 ResizeScale: random scale of the *target* size, then fit input inside
    scale = rng.uniform(min_scale, max_scale)
    target_h = image_size * scale
    target_w = image_size * scale
    output_scale = min(target_h / img_h, target_w / img_w)
    new_h = int(img_h * output_scale + 0.5)
    new_w = int(img_w * output_scale + 0.5)
    # d2 FixedSizeCrop: random crop if larger, pad bottom-right if smaller
    max_off_h = max(new_h - image_size, 0)
    max_off_w = max(new_w - image_size, 0)
    off_h = int(rng.uniform(0, 1) * (max_off_h + 1)) if max_off_h else 0
    off_w = int(rng.uniform(0, 1) * (max_off_w + 1)) if max_off_w else 0
    off_h = min(off_h, max_off_h)
    off_w = min(off_w, max_off_w)
    return TransformRecord(
        flip=do_flip, src_w=img_w,
        scale_x=new_w / img_w, scale_y=new_h / img_h,
        tx=-off_w, ty=-off_h, out_h=image_size, out_w=image_size)


def resize_shortest_edge(
    rng: Optional[np.random.RandomState],
    img_h: int,
    img_w: int,
    short_edge_length: Sequence[int],
    max_size: int = 1333,
    sample_style: str = "choice",
    flip: bool = False,
) -> TransformRecord:
    """d2 ResizeShortestEdge geometry (+ an optional flip): the short side
    drawn from `short_edge_length` ("choice") or from its closed range
    ("range"), the long side capped at `max_size`; without `rng` the first
    length and no flip (`mp_former_tpu/data/transforms.py:116-144`)."""
    if sample_style == "range":
        size = int(rng.randint(min(short_edge_length), max(short_edge_length) + 1))
    else:
        size = int(short_edge_length[rng.randint(len(short_edge_length))]) if rng is not None \
            else int(short_edge_length[0])
    scale = size / min(img_h, img_w)
    if img_h < img_w:
        new_h, new_w = size, scale * img_w
    else:
        new_h, new_w = scale * img_h, size
    if max(new_h, new_w) > max_size:
        s = max_size / max(new_h, new_w)
        new_h, new_w = new_h * s, new_w * s
    new_h = int(new_h + 0.5)
    new_w = int(new_w + 0.5)
    do_flip = random_flip(rng, flip) if rng is not None else False
    return TransformRecord(
        flip=do_flip, src_w=img_w, scale_x=new_w / img_w, scale_y=new_h / img_h,
        tx=0.0, ty=0.0, out_h=new_h, out_w=new_w)


def color_aug_ssd(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """SSD-style photometric distortion (d2 ColorAugSSDTransform as the JAX
    package has it, `mp_former_tpu/data/transforms.py:170-199`): brightness,
    then contrast and saturation in a random order, each applied with
    probability 1/2, in float32; (H, W, 3) uint8 in and out."""
    img = img.astype(np.float32)

    def brightness(x):
        if rng.randint(2):
            x = x + rng.uniform(-32, 32)
        return x

    def contrast(x):
        if rng.randint(2):
            x = x * rng.uniform(0.5, 1.5)
        return x

    def saturation(x):
        if rng.randint(2):
            gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
            alpha = rng.uniform(0.5, 1.5)
            x = x * alpha + gray[..., None] * (1 - alpha)
        return x

    img = brightness(img)
    if rng.randint(2):
        img = contrast(img)
        img = saturation(img)
    else:
        img = saturation(img)
        img = contrast(img)
    return np.clip(img, 0, 255).astype(np.uint8)


def apply_record_to_image(img: np.ndarray, rec: TransformRecord,
                          pad_value: float = 128.0) -> np.ndarray:
    """Apply flip/resize/crop-or-pad to an (H, W, C) uint8 image."""
    out = img[:, ::-1] if rec.flip else img
    new_h = int(round(img.shape[0] * rec.scale_y))
    new_w = int(round(img.shape[1] * rec.scale_x))
    out = _resize_image(out, new_h, new_w)
    y0, x0 = int(-rec.ty), int(-rec.tx)
    crop = out[y0: y0 + rec.out_h, x0: x0 + rec.out_w]
    canvas = np.full((rec.out_h, rec.out_w, out.shape[2]), pad_value, dtype=out.dtype)
    canvas[: crop.shape[0], : crop.shape[1]] = crop
    return canvas


def resize_nearest(mask: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """cv2.resize(..., INTER_NEAREST) of a 2-D map of any type: source index
    floor(dst * (1 / (dst_n / src_n))) in float64, clipped to the last row or
    column (the reciprocal of the ratio, not src_n / dst_n, which rounds
    otherwise on some sizes)."""
    h, w = mask.shape
    ys = np.minimum(np.floor(np.arange(new_h) * (1.0 / (new_h / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(new_w) * (1.0 / (new_w / w))).astype(np.int64), w - 1)
    return mask[ys[:, None], xs[None, :]]


def apply_to_sem_seg(sem: np.ndarray, rec: TransformRecord, ignore) -> np.ndarray:
    """A 2-D map through the record (`mp_former_tpu/data/dataset_mappers/
    mask_former_mappers.py:30-40 _apply_to_sem_seg`): flip, nearest resize,
    crop, and pad with `ignore`."""
    out = sem[:, ::-1] if rec.flip else sem
    out = resize_nearest(out, int(round(sem.shape[0] * rec.scale_y)),
                         int(round(sem.shape[1] * rec.scale_x)))
    y0, x0 = int(-rec.ty), int(-rec.tx)
    crop = out[y0: y0 + rec.out_h, x0: x0 + rec.out_w]
    canvas = np.full((rec.out_h, rec.out_w), ignore, dtype=sem.dtype)
    canvas[: crop.shape[0], : crop.shape[1]] = crop
    return canvas


def resolve_gt_mask_stride(cfg) -> int:
    """TPU.GT_MASK_STRIDE with 0 = auto: ground-truth masks at 1/4 of the
    canvas when the grid-mode loss is active (it resizes them to the 1/4
    prediction grid anyway), full resolution otherwise."""
    stride = cfg.TPU.GT_MASK_STRIDE
    if stride == 0:
        stride = 4 if cfg.TPU.POINT_SAMPLE_MODE == "grid" else 1
    return stride


def block_any_pool(mask: np.ndarray, stride: int) -> np.ndarray:
    """Max ('any') pool a boolean mask by stride: a ground-truth pixel
    anywhere in a stride x stride block marks the block, so thin (1-2 px)
    structures survive, unlike [::s, ::s] point sampling."""
    if stride == 1:
        return mask
    h, w = mask.shape
    hp = (h + stride - 1) // stride * stride
    wp = (w + stride - 1) // stride * stride
    if (hp, wp) != (h, w):
        p = np.zeros((hp, wp), mask.dtype)
        p[:h, :w] = mask
        mask = p
    return mask.reshape(hp // stride, stride, wp // stride, stride).any((1, 3))
