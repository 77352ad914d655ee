#!/usr/bin/env python
"""Generate a learnable synthetic COCO-format instance dataset for the
PyTorch port, with numpy and the port's polygon rasteriser only (no cv2, no
image codec), so that it runs where the port runs.

The same distribution as `tools/make_synthetic_coco.py`: hue-coded classes
(even classes ellipses, odd classes rotated rectangles), 3-8 objects an image
on a low-frequency background, exact polygon segmentations. Images are written
as `.npy` (H, W, 3) uint8 BGR arrays, which `engine/eval_loop.py::read_image`
loads; the objects are painted with the rasteriser that turns the polygons
into ground truth (`mp_former_tpu_torch/native`), so pixels and ground truth
agree exactly. A later object paints over an earlier one; the earlier one's
polygon stays whole, as in the cv2 tool.

    python tools/make_synthetic_coco_torch.py --root /tmp/synth_coco \
        [--images 200] [--size 640] [--classes 20] [--split train2017] [--seed 0] [--panoptic]

writes `$ROOT/coco/<split>/<id>.npy` and
`$ROOT/coco/annotations/instances_<split>.json`: the layout that
`coco_2017_train` / `coco_2017_val` read with DETECTRON2_DATASETS=$ROOT.

`--panoptic` (after `tools/make_synthetic_coco.py --panoptic`) also writes the
COCO panoptic layout that `coco_2017_{train,val}_panoptic[_with_sem_seg]`
read: the shape classes are things (ids 1..classes), the whole background is
one segment of one stuff class "background" (id classes + 1, `isthing 0`),
and each painted object a segment of its class, its area counted after the
objects painted over it (a segment painted over entirely is left out).
- `coco/panoptic_<split>/<id>.npy`: the id map, (H, W) uint32 segment ids
  (the PNG's R + 256 G + 65536 B), 0 = no segment;
- `coco/annotations/panoptic_<split>.json`: images, categories (with
  `isthing`) and per image `segments_info` ({id, category_id, iscrowd, area,
  bbox}), the id map's file name under `file_name`;
- `coco/panoptic_semseg_<split>/<id>.npy`: the semantic map, (H, W) uint8
  contiguous class ids, things first, then stuff, 255 where no segment lies
  (the rule of `datasets/prepare_coco_semantic_annos_from_panoptic_annos.py`).
The draws are those of the instance dataset: the same seed gives the same
images and instance json with or without `--panoptic`.
"""

import argparse
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mp_former_tpu_torch.native import polygons_to_mask  # noqa: E402


def hsv_to_bgr(h: int, s: int, v: int) -> np.ndarray:
    """One colour in OpenCV's 8-bit HSV (hue 0-179 in steps of 2 degrees,
    saturation and value 0-255) -> BGR int32, by the standard formula."""
    hue, sat, val = h * 2 / 60.0, s / 255.0, v / 255.0
    i, f = int(np.floor(hue)) % 6, hue - np.floor(hue)
    p, q, t = val * (1 - sat), val * (1 - sat * f), val * (1 - sat * (1 - f))
    r, g, b = [(val, t, p), (q, val, p), (p, val, t), (p, q, val), (t, p, val), (val, p, q)][i]
    return np.round(np.array([b, g, r]) * 255).astype(np.int32)


def class_color(c: int, num_classes: int) -> np.ndarray:
    """A distinct saturated BGR colour per class (the class is learnable from
    its appearance)."""
    return hsv_to_bgr(int(179 * c / max(num_classes, 1)), 230, 220)


def ellipse_polygon(cx, cy, ax, ay, angle, k=16):
    ts = np.linspace(0, 2 * np.pi, k, endpoint=False)
    ca, sa = np.cos(angle), np.sin(angle)
    xs = cx + ax * np.cos(ts) * ca - ay * np.sin(ts) * sa
    ys = cy + ax * np.cos(ts) * sa + ay * np.sin(ts) * ca
    return np.stack([xs, ys], -1)


def rotated_rect_polygon(cx, cy, w, h, angle):
    """The 4 corners of a w x h rectangle centred at (cx, cy), turned by
    `angle` radians (cv2.boxPoints' order)."""
    b, a = np.cos(angle) * 0.5, np.sin(angle) * 0.5
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    return np.array([p0, p1, (2 * cx - p0[0], 2 * cy - p0[1]), (2 * cx - p1[0], 2 * cy - p1[1])])


def smooth_background(small: np.ndarray, size: int) -> np.ndarray:
    """(n, n, 3) uint8 -> (size, size, 3) uint8, bilinear with half-pixel
    centres (a low-frequency texture)."""
    n = small.shape[0]
    c = np.clip((np.arange(size) + 0.5) * n / size - 0.5, 0, n - 1)
    i0 = np.floor(c).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    f = c - i0
    x = small.astype(np.float64)
    rows = x[i0] * (1 - f)[:, None, None] + x[i1] * f[:, None, None]
    out = rows[:, i0] * (1 - f)[None, :, None] + rows[:, i1] * f[None, :, None]
    return np.round(out).astype(np.uint8)


def semantic_map(ids: np.ndarray, segments, categories) -> np.ndarray:
    """(H, W) uint8 contiguous class ids from an id map and its segments:
    categories ordered things first, then stuff, each by id; 255 where no
    segment lies (`datasets/prepare_coco_semantic_annos_from_panoptic_annos.py:
    21-35`)."""
    order = sorted(categories, key=lambda c: (not c["isthing"], c["id"]))
    contiguous = {c["id"]: i for i, c in enumerate(order)}
    out = np.full(ids.shape, 255, np.uint8)
    for seg in segments:
        out[ids == seg["id"]] = contiguous[seg["category_id"]]
    return out


def write_dataset(root: str, images: int = 200, size: int = 640, classes: int = 20,
                  split: str = "train2017", seed: int = 0, panoptic: bool = False) -> str:
    """Write the split (with `panoptic`, its panoptic id maps, json and
    semantic maps too); returns the path of its instance json."""
    img_dir = os.path.join(root, "coco", split)
    ann_dir = os.path.join(root, "coco", "annotations")
    pan_dir = os.path.join(root, "coco", f"panoptic_{split}")
    sem_dir = os.path.join(root, "coco", f"panoptic_semseg_{split}")
    for d in (img_dir, ann_dir) + ((pan_dir, sem_dir) if panoptic else ()):
        os.makedirs(d, exist_ok=True)
    categories = [{"id": c + 1, "name": f"shape-{c}", "isthing": 1} for c in range(classes)]
    categories.append({"id": classes + 1, "name": "background", "isthing": 0})
    rng = np.random.RandomState(seed)
    s = size
    image_list, annotations, pan_annotations = [], [], []
    aid = 1
    for i in range(images):
        noise = rng.rand(s // 16, s // 16, 3)
        img = smooth_background((noise * 80 + 40).astype(np.uint8), s)
        ids = np.ones((s, s), np.uint32)  # the background: segment 1
        segments = [{"id": 1, "category_id": classes + 1, "iscrowd": 0,
                     "bbox": [0.0, 0.0, float(s), float(s)]}]
        for _ in range(rng.randint(3, 9)):
            c = int(rng.randint(classes))
            color = class_color(c, classes)
            jitter = rng.randint(-25, 26, 3)
            col = np.clip(color + jitter, 0, 255).astype(np.uint8)
            cx, cy = rng.randint(s // 8, 7 * s // 8, 2)
            ax_, ay_ = rng.randint(s // 20, s // 5, 2)
            ang = rng.rand() * np.pi
            if c % 2 == 0:  # even classes: ellipses
                pts = ellipse_polygon(cx, cy, ax_, ay_, ang)
            else:           # odd classes: rotated rectangles
                pts = rotated_rect_polygon(float(cx), float(cy), float(ax_ * 2),
                                           float(ay_ * 2), ang)
            pts[:, 0] = np.clip(pts[:, 0], 0, s - 1)
            pts[:, 1] = np.clip(pts[:, 1], 0, s - 1)
            x0, y0 = pts.min(0)
            x1, y1 = pts.max(0)
            if (x1 - x0) < 4 or (y1 - y0) < 4:
                continue  # checked before painting: a painted object must be annotated
            polygon = pts.reshape(-1).tolist()
            mask = polygons_to_mask([polygon], s, s)
            if not mask.any():
                continue
            img[mask] = col
            bbox = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
            annotations.append({
                "id": aid, "image_id": i + 1, "category_id": c + 1, "bbox": bbox,
                "area": float(mask.sum()), "iscrowd": 0, "segmentation": [polygon],
            })
            aid += 1
            ids[mask] = len(segments) + 1
            segments.append({"id": len(segments) + 1, "category_id": c + 1, "iscrowd": 0,
                             "bbox": bbox})
        fn = f"{i + 1:012d}.npy"
        np.save(os.path.join(img_dir, fn), img)
        image_list.append({"id": i + 1, "file_name": fn, "height": s, "width": s})
        if panoptic:
            # areas after the objects painted over earlier ones
            area = np.bincount(ids.reshape(-1), minlength=len(segments) + 1)
            segments = [dict(seg, area=float(area[seg["id"]])) for seg in segments
                        if area[seg["id"]]]
            np.save(os.path.join(pan_dir, fn), ids)
            np.save(os.path.join(sem_dir, fn), semantic_map(ids, segments, categories))
            pan_annotations.append({"image_id": i + 1, "file_name": fn,
                                    "segments_info": segments})
    data = {"images": image_list, "annotations": annotations,
            "categories": [{"id": c["id"], "name": c["name"]} for c in categories[:-1]]}
    out = os.path.join(ann_dir, f"instances_{split}.json")
    with open(out, "w") as f:
        json.dump(data, f)
    if panoptic:
        with open(os.path.join(ann_dir, f"panoptic_{split}.json"), "w") as f:
            json.dump({"images": image_list, "annotations": pan_annotations,
                       "categories": categories}, f)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--images", type=int, default=200)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--classes", type=int, default=20)
    p.add_argument("--split", default="train2017")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--panoptic", action="store_true",
                   help="also write the panoptic id maps, json and semantic maps")
    args = p.parse_args(argv)
    out = write_dataset(args.root, args.images, args.size, args.classes, args.split, args.seed,
                        args.panoptic)
    with open(out) as f:
        n_ann = len(json.load(f)["annotations"])
    print(f"{args.images} images, {n_ann} annotations -> {out}")


if __name__ == "__main__":
    main()
