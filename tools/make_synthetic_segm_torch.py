#!/usr/bin/env python
"""Generate small seeded ADE20K, Cityscapes and Mapillary Vistas datasets in
each dataset's own directory layout, for the PyTorch port's semantic,
instance and panoptic recipes, with numpy and the port's polygon rasteriser
only (no cv2, no image codec), so that it runs where the port runs.

Each image is a scene of the dataset's own classes: horizontal bands of
stuff classes, a few stuff blobs, then objects of thing classes (ellipses or
rotated rectangles, polygons rasterised by `mp_former_tpu_torch/native`, a
later one painted over an earlier one), each class in its own colour over a
low-frequency texture. Images are written as `.npy` (H, W, 3) uint8 BGR,
maps as `.npy` (H, W) integers, under the names the registrations of
`mp_former_tpu_torch/data/datasets/register_all.py` pair (the `.npy` twin of
each `.png` / `.jpg`); json files name the `.png` / `.jpg` files, as the real
datasets do. The same draws give the same arrays whatever is written from
them, so a test can write PNG files of the same arrays for a reader that
decodes them.

    python tools/make_synthetic_segm_torch.py --root /tmp/segm \
        --dataset {ade20k,cityscapes,mapillary} [--split train] [--images 8] \
        [--height H] [--width W] [--seed 0]

writes, with DETECTRON2_DATASETS=$ROOT:

- ade20k (`ade20k_sem_seg_*`, `ade20k_instance_*`, `ade20k_panoptic_*`):
  `ADEChallengeData2016/images/{training,validation}/ADE_{train,val}_<8
  digits>.npy`, `annotations_detectron2/<dir>/<same>.npy` (uint8, the 150
  classes 0..149, 255 unlabelled), `ade20k_instance_<split>.json` (COCO
  format, the 100 thing classes under their ADE20K-150 ids, polygons),
  `ade20k_panoptic_<split>.json` and `ade20k_panoptic_<split>/<stem>.npy`
  (uint32 segment ids: a segment a stuff class present, one a thing object);
- cityscapes (`cityscapes_fine_{sem_seg,instance_seg,panoptic}_*`):
  `cityscapes/leftImg8bit/<split>/<city>/<city>_<seq>_<frame>_leftImg8bit.npy`;
  beside them under `gtFine/<split>/<city>/`: `_gtFine_polygons.json`
  (every object in painting order, crowd regions as "<label>group"),
  `_gtFine_labelIds.npy`, `_gtFine_labelTrainIds.npy` (uint8, 255 ignored),
  `_gtFine_instanceIds.npy` (int32: labelId * 1000 + instance for things,
  the labelId elsewhere); `gtFine/cityscapes_panoptic_<split>.json` and
  `gtFine/cityscapes_panoptic_<split>/<stem>_gtFine_panoptic.npy`
  (createPanopticImgs' ids: the instance id for things, the labelId for
  stuff; categories by labelId);
- mapillary (`mapillary_vistas_{sem_seg,panoptic}_*`):
  `mapillary_vistas/{training,validation}/images/<key>.npy`, `labels/<key>.npy`
  (uint8, the 65 evaluated classes 0..64, 65 unlabelled),
  `panoptic/panoptic_2018.json` and `panoptic/<key>.npy` (uint32 ids;
  categories 1..65).
"""

import argparse
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mp_former_tpu_torch.data.datasets import metadata as M  # noqa: E402
from mp_former_tpu_torch.data.datasets.cityscapes_labels import LABELS  # noqa: E402
from mp_former_tpu_torch.native import polygons_to_mask  # noqa: E402
from tools.make_synthetic_coco_torch import (ellipse_polygon, hsv_to_bgr,  # noqa: E402
                                             rotated_rect_polygon)

DATASETS = ("ade20k", "cityscapes", "mapillary")
DEFAULT_SIZE = {"ade20k": (512, 683), "cityscapes": (1024, 2048), "mapillary": (1536, 2048)}
CITIES = ("aachen", "bochum", "cologne")


def scene(rng, h: int, w: int, stuff, things, n_things=(3, 9), small_p: float = 0.0,
          crowd_p: float = 0.0, void=None):
    """One scene: `(label (H, W) int64 class map, segment (H, W) int64 object
    index map, objects)`. Classes are the dataset's own ids (`stuff`,
    `things`, `void`); objects are dicts {cls, polygon (N, 2), thing, crowd}
    in painting order, each with the index its pixels carry in the object map;
    an object painted over entirely is kept in the list (as a polygon file
    keeps it) and has no pixels left."""
    label = np.zeros((h, w), np.int64)
    segment = np.full((h, w), -1, np.int64)
    objects = []

    def paint(cls, pts, thing=False, crowd=False):
        pts = np.asarray(pts, np.float64)
        pts[:, 0] = np.clip(pts[:, 0], 0, w)
        pts[:, 1] = np.clip(pts[:, 1], 0, h)
        mask = polygons_to_mask([pts.reshape(-1).tolist()], h, w)
        label[mask] = cls
        segment[mask] = len(objects)
        objects.append({"cls": int(cls), "polygon": pts, "thing": thing, "crowd": crowd})

    bounds = np.sort(rng.randint(h // 5, 4 * h // 5, 2))
    for y0, y1 in zip((0, bounds[0], bounds[1]), (bounds[0], bounds[1], h)):
        paint(stuff[rng.randint(len(stuff))], [[0, y0], [w, y0], [w, y1], [0, y1]])
    for _ in range(rng.randint(0, 3)):
        cx, cy = rng.randint(0, w), rng.randint(0, h)
        paint(stuff[rng.randint(len(stuff))],
              ellipse_polygon(cx, cy, rng.randint(w // 16, w // 4), rng.randint(h // 16, h // 4),
                              rng.rand() * np.pi))
    if void is not None:  # a strip along the bottom (Cityscapes' ego vehicle)
        paint(void, [[0, h - h // 16], [w, h - h // 16], [w, h], [0, h]])
    for _ in range(rng.randint(*n_things)):
        cls = things[rng.randint(len(things))]
        small = rng.rand() < small_p
        crowd = rng.rand() < crowd_p
        cx, cy = rng.randint(w // 16, 15 * w // 16), rng.randint(h // 16, 15 * h // 16)
        if small:  # below the 100 px of the Cityscapes instance protocol
            ax, ay = rng.randint(2, 5, 2)
        else:
            ax, ay = rng.randint(min(h, w) // 24, min(h, w) // 5, 2)
        ang = rng.rand() * np.pi
        if rng.rand() < 0.5:
            pts = ellipse_polygon(cx, cy, ax, ay, ang)
        else:
            pts = rotated_rect_polygon(float(cx), float(cy), float(2 * ax), float(2 * ay), ang)
        paint(cls, pts, thing=True, crowd=crowd)
    return label, segment, objects


def render(rng, label: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR: each class's colour (`palette[label]`) over a
    low-frequency texture (noise on a grid of 32-pixel cells, bilinear), with
    per-pixel noise."""
    h, w = label.shape
    small = rng.rand(h // 32 + 2, w // 32 + 2, 3).astype(np.float32) * 60

    def axis(n, m):  # source cells and weights of bilinear, half-pixel centres
        c = np.clip((np.arange(n) + 0.5) * m / n - 0.5, 0, m - 1).astype(np.float32)
        i0 = np.floor(c).astype(np.int64)
        return i0, np.minimum(i0 + 1, m - 1), (c - i0)[:, None]

    y0, y1, fy = axis(h, small.shape[0])
    x0, x1, fx = axis(w, small.shape[1])
    rows = small[y0] * (1 - fy[..., None]) + small[y1] * fy[..., None]
    tex = rows[:, x0] * (1 - fx[None]) + rows[:, x1] * fx[None]
    img = (palette[label].astype(np.int16) + tex.astype(np.int16) - 30
           + rng.randint(-8, 9, (h, w, 3), dtype=np.int8))
    return np.clip(img, 0, 255).astype(np.uint8)


def palette_for(n: int) -> np.ndarray:
    return np.stack([hsv_to_bgr(int(179 * c / n), 200 + 55 * (c % 2), 110 + 110 * (c % 3 == 0))
                     for c in range(n)]).astype(np.uint8)


def _bbox(mask: np.ndarray) -> list:
    ys, xs = np.nonzero(mask)
    return [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
            float(ys.max() - ys.min() + 1)]


def _panoptic_segments(segment, objects, category, seg_id):
    """(id map uint32, segments_info): one segment per stuff class present,
    one per thing object with pixels; `category(obj)` its dataset category
    id, `seg_id(obj, k)` the id of the k-th segment."""
    ids = np.zeros(segment.shape, np.uint32)
    segments, region_ids = [], {}
    for k, obj in enumerate(objects):
        mask = segment == k
        if not mask.any():
            continue
        cat = category(obj)
        # a thing object is a segment of its own; a stuff class, or a crowd
        # region of a thing class, one segment for all its pixels
        key = k if obj["thing"] and not obj["crowd"] else (cat, obj["crowd"])
        if key not in region_ids:
            region_ids[key] = int(seg_id(obj, len(segments)))
            segments.append({"id": region_ids[key], "category_id": int(cat),
                             "iscrowd": int(obj["crowd"]), "area": 0, "bbox": [0, 0, 0, 0]})
        ids[mask] = region_ids[key]
    for seg in segments:
        m = ids == seg["id"]
        seg["area"] = int(m.sum())
        seg["bbox"] = _bbox(m)
    return ids, segments


def write_ade20k(root, split, images, h, w, seed):
    cats = M._load("ade20k_150_categories")
    stuff = [c["id"] for c in cats if not c["isthing"]]
    things = [c["id"] for c in cats if c["isthing"]]
    dirn = "training" if split == "train" else "validation"
    base = os.path.join(root, "ADEChallengeData2016")
    img_dir = os.path.join(base, "images", dirn)
    sem_dir = os.path.join(base, "annotations_detectron2", dirn)
    pan_dir = os.path.join(base, f"ade20k_panoptic_{split}")
    for d in (img_dir, sem_dir, pan_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    palette = palette_for(150)
    image_list, annotations, pan_annotations = [], [], []
    for i in range(images):
        label, segment, objects = scene(rng, h, w, stuff, things)
        stem = f"ADE_{split}_{i + 1:08d}"
        np.save(os.path.join(img_dir, stem + ".npy"), render(rng, label, palette))
        np.save(os.path.join(sem_dir, stem + ".npy"), label.astype(np.uint8))
        image_list.append({"id": i + 1, "file_name": stem + ".jpg", "height": h, "width": w})
        for k, obj in enumerate(objects):
            if obj["thing"] and (segment == k).any():
                annotations.append({
                    "id": len(annotations) + 1, "image_id": i + 1, "category_id": obj["cls"],
                    "iscrowd": 0, "area": float((segment == k).sum()),
                    "bbox": _bbox(segment == k),
                    "segmentation": [obj["polygon"].reshape(-1).tolist()]})
        ids, segments = _panoptic_segments(segment, objects, lambda o: o["cls"],
                                           lambda o, n: n + 1)
        np.save(os.path.join(pan_dir, stem + ".npy"), ids)
        pan_annotations.append({"image_id": i + 1, "file_name": stem + ".png",
                                "segments_info": segments})
    inst_cats = [{"id": c["id"], "name": c["name"]} for c in M._load("ade20k_instance_categories")]
    with open(os.path.join(base, f"ade20k_instance_{split}.json"), "w") as f:
        json.dump({"images": image_list, "annotations": annotations, "categories": inst_cats}, f)
    with open(os.path.join(base, f"ade20k_panoptic_{split}.json"), "w") as f:
        json.dump({"images": image_list, "annotations": pan_annotations, "categories": cats}, f)
    return images


def write_cityscapes(root, split, images, h, w, seed):
    by_name = {lab.name: lab for lab in LABELS}
    stuff = [by_name[n].id for n in ("road", "sidewalk", "building", "vegetation", "sky",
                                     "terrain", "wall", "fence")]
    things = [lab.id for lab in LABELS if lab.hasInstances and not lab.ignoreInEval]
    things += [by_name["pole"].id, by_name["traffic sign"].id, by_name["traffic light"].id]
    id_to_label = {lab.id: lab for lab in LABELS}
    train_lut = np.full(256, 255, np.uint8)
    for lab in LABELS:
        if lab.id >= 0:
            train_lut[lab.id] = lab.trainId if 0 <= lab.trainId < 255 else 255
    base = os.path.join(root, "cityscapes")
    pan_dir = os.path.join(base, "gtFine", f"cityscapes_panoptic_{split}")
    os.makedirs(pan_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    palette = palette_for(34)
    image_list, pan_annotations = [], []
    for i in range(images):
        city = CITIES[i % len(CITIES)]
        stem = f"{city}_{i // len(CITIES):06d}_{19 + i:06d}"
        img_dir = os.path.join(base, "leftImg8bit", split, city)
        gt_dir = os.path.join(base, "gtFine", split, city)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        label, segment, objects = scene(rng, h, w, stuff, things, n_things=(4, 12),
                                        small_p=0.15, crowd_p=0.1, void=by_name["ego vehicle"].id)
        for obj in objects:  # things of a class without instances are stuff objects
            obj["thing"] = obj["thing"] and id_to_label[obj["cls"]].hasInstances
            obj["crowd"] = obj["crowd"] and obj["thing"]
        inst = label.astype(np.int32)
        counts = {}
        for k, obj in enumerate(objects):
            if obj["thing"] and not obj["crowd"]:
                n = counts.get(obj["cls"], 0)
                counts[obj["cls"]] = n + 1
                obj["instance_id"] = obj["cls"] * 1000 + n
                inst[segment == k] = obj["instance_id"]
        np.save(os.path.join(img_dir, stem + "_leftImg8bit.npy"), render(rng, label, palette))
        np.save(os.path.join(gt_dir, stem + "_gtFine_labelIds.npy"), label.astype(np.uint8))
        np.save(os.path.join(gt_dir, stem + "_gtFine_labelTrainIds.npy"), train_lut[label])
        np.save(os.path.join(gt_dir, stem + "_gtFine_instanceIds.npy"), inst)
        polygons = {"imgHeight": h, "imgWidth": w, "objects": [
            {"label": id_to_label[o["cls"]].name + ("group" if o["crowd"] else ""),
             "polygon": o["polygon"].tolist()} for o in objects]}
        with open(os.path.join(gt_dir, stem + "_gtFine_polygons.json"), "w") as f:
            json.dump(polygons, f)
        # createPanopticImgs: evaluated labels only, void pixels 0
        keep = np.isin(segment, [k for k, o in enumerate(objects)
                                 if not id_to_label[o["cls"]].ignoreInEval])
        ids, segments = _panoptic_segments(
            np.where(keep, segment, -1), objects, lambda o: o["cls"],
            lambda o, n: o.get("instance_id", o["cls"]))
        np.save(os.path.join(pan_dir, stem + "_gtFine_panoptic.npy"), ids)
        image_list.append({"id": stem, "file_name": stem + "_leftImg8bit.png", "height": h,
                           "width": w})
        pan_annotations.append({"image_id": stem, "file_name": stem + "_gtFine_panoptic.png",
                                "segments_info": segments})
    categories = [{"id": lab.id, "name": lab.name, "isthing": int(lab.hasInstances),
                   "supercategory": lab.category}
                  for lab in LABELS if not lab.ignoreInEval]
    with open(os.path.join(base, "gtFine", f"cityscapes_panoptic_{split}.json"), "w") as f:
        json.dump({"images": image_list, "annotations": pan_annotations,
                   "categories": categories}, f)
    return images


def write_mapillary(root, split, images, h, w, seed):
    cats = M._load("mapillary_vistas_panoptic_categories")  # ids 1..65, contiguous + 1
    stuff = [c["id"] for c in cats if not c["isthing"]]
    things = [c["id"] for c in cats if c["isthing"]]
    base = os.path.join(root, "mapillary_vistas", "training" if split == "train" else "validation")
    img_dir, lab_dir, pan_dir = (os.path.join(base, d) for d in ("images", "labels", "panoptic"))
    for d in (img_dir, lab_dir, pan_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    palette = palette_for(66)
    image_list, pan_annotations = [], []
    for i in range(images):
        label, segment, objects = scene(rng, h, w, stuff, things)
        key = f"{split}{i:04d}-synthetic"
        np.save(os.path.join(img_dir, key + ".npy"), render(rng, label, palette))
        np.save(os.path.join(lab_dir, key + ".npy"), (label - 1).astype(np.uint8))
        ids, segments = _panoptic_segments(segment, objects, lambda o: o["cls"],
                                           lambda o, n: n + 1)
        np.save(os.path.join(pan_dir, key + ".npy"), ids)
        image_list.append({"id": key, "file_name": key + ".jpg", "height": h, "width": w})
        pan_annotations.append({"image_id": key, "file_name": key + ".png",
                                "segments_info": segments})
    with open(os.path.join(pan_dir, "panoptic_2018.json"), "w") as f:
        json.dump({"images": image_list, "annotations": pan_annotations, "categories": cats}, f)
    return images


def instance_ids_from_predictions(predictions, thing_label_ids, min_share=0.97,
                                  min_pixels=100) -> list:
    """Cityscapes `_gtFine_instanceIds` maps (0, unlabelled, where no
    instance lies), one an image, on which the images' instance predictions
    score AP 100 (`evaluation/cityscapes_eval.py`, which ranks a class's
    predictions over the whole dataset). `predictions`: (scores, classes,
    masks) an image. In the order of falling score over all images, each
    prediction of a class becomes a ground truth instance (labelId * 1000 +
    k) on its image's pixels not yet taken, while those are at least
    `min_share` of its mask and `min_pixels` (the protocol's minimum region);
    a class's first prediction that fails that ends the class, so every later
    one of it scores below its matched ones. `thing_label_ids[c]`: the
    labelId of the model's class c, -1 for a class that is no thing."""
    maps = [np.zeros(masks.shape[1:], np.int32) for _, _, masks in predictions]
    ranked = sorted(((float(s), n, i) for n, (scores, _, _) in enumerate(predictions)
                     for i, s in enumerate(scores)), key=lambda x: -x[0])
    ended, counts = set(), {}
    for _, n, i in ranked:
        _, classes, masks = predictions[n]
        c = int(classes[i])
        lab = int(thing_label_ids[c])
        if lab < 0 or c in ended:
            continue
        free = masks[i] & (maps[n] == 0)
        k = int(free.sum())
        if k < min_pixels or k < min_share * int(masks[i].sum()):
            ended.add(c)
            continue
        maps[n][free] = lab * 1000 + counts.get(c, 0)
        counts[c] = counts.get(c, 0) + 1
    return maps


WRITERS = {"ade20k": write_ade20k, "cityscapes": write_cityscapes, "mapillary": write_mapillary}


def write_dataset(root: str, dataset: str, split: str = "train", images: int = 8,
                  height: int = 0, width: int = 0, seed: int = 0) -> int:
    """Write `images` images of `dataset`'s `split` ("train" or "val") under
    `root`; height and width 0 take the dataset's typical size."""
    if dataset not in WRITERS:
        raise ValueError(f"--dataset {dataset}: one of {DATASETS}")
    if split not in ("train", "val"):
        raise ValueError(f"--split {split}: train or val")
    dh, dw = DEFAULT_SIZE[dataset]
    return WRITERS[dataset](root, split, images, height or dh, width or dw, seed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--dataset", required=True, choices=DATASETS)
    p.add_argument("--split", default="train", choices=("train", "val"))
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    n = write_dataset(args.root, args.dataset, args.split, args.images, args.height, args.width,
                      args.seed)
    print(f"{n} {args.dataset} {args.split} images -> {args.root}")


if __name__ == "__main__":
    main()
