"""Host-side augmentations of the LSJ recipe (the parts of
`mp_former_tpu/data/transforms.py` that `coco_instance_lsj` needs): RandomFlip
-> ResizeScale(MIN_SCALE..MAX_SCALE of IMAGE_SIZE) -> FixedSizeCrop
(IMAGE_SIZE^2, padded with 128), as d2's transforms the reference uses.

A transform is drawn as a `TransformRecord`, which re-applies the geometric
map to coordinates, polygons, masks and the image. The draws from the
`np.random.RandomState` are the JAX package's, in its order, so the same
state gives the same record. The image is resized with `F.interpolate`
(bilinear, half-pixel centres, as cv2's INTER_LINEAR) on the CPU and rounded
to uint8; cv2 computes uint8 in fixed point, so a pixel may differ from the
JAX package's by a grey level. Polygons are rasterised by
`native.polygons_to_mask` (pycocotools' rule, the JAX package's native route).
"""

from __future__ import annotations

from dataclasses import dataclass

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


def _resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8, bilinear with half-pixel centres."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    return x.round_().clamp_(0, 255)[0].permute(1, 2, 0).to(torch.uint8).numpy()


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
