#!/usr/bin/env python
"""Generate a synthetic LVIS v1 split for the PyTorch port, with numpy and
the port's polygon rasteriser only (no cv2, no image codec).

The images and their exact polygons are those of
`tools/make_synthetic_coco_torch.py` (`write_dataset`, the same seed gives
the same pixels), written under `$ROOT/coco/<split>2017/` as `.npy`; the
annotations are rewritten into LVIS v1's format at
`$ROOT/lvis/lvis_v1_<split>.json`, the layout `lvis_v1_train` /
`lvis_v1_val` read with DETECTRON2_DATASETS=$ROOT:

- 1203 categories (LVIS v1's count), `frequency` r, c, f in turn by id, so
  that the shape classes (ids 1..classes) put ground truth in every bucket;
- images name only a `coco_url` (`http://images.cocodataset.org/<split>2017/
  <id>.jpg`; the `.npy` twin serves), with `neg_category_ids` (categories
  verified absent: shape classes the image lacks and ids beyond them) and
  `not_exhaustive_category_ids` (some of its own classes), each non-empty on
  some images and empty on others;
- annotations keep their polygons, area and bbox; LVIS has no crowd.

    python tools/make_synthetic_lvis_torch.py --root /tmp/synth_lvis \
        [--split val] [--images 8] [--size 512] [--classes 20] [--seed 0]
"""

import argparse
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tools.make_synthetic_coco_torch import write_dataset  # noqa: E402

LVIS_V1_CATEGORIES = 1203
FREQUENCIES = ("r", "c", "f")


def write_lvis(root: str, split: str = "val", images: int = 8, size: int = 512,
               classes: int = 20, seed: int = 0) -> str:
    """Write the split; returns the path of its LVIS json."""
    coco_split = f"{split}2017"
    with open(write_dataset(root, images, size, classes, coco_split, seed)) as f:
        coco = json.load(f)
    rng = np.random.RandomState(seed + 1000)
    present = {}
    for a in coco["annotations"]:
        a.pop("iscrowd", None)
        present.setdefault(a["image_id"], set()).add(a["category_id"])
    lvis_images = []
    for i, img in enumerate(coco["images"]):
        own = sorted(present.get(img["id"], ()))
        absent = [c for c in range(1, classes + 1) if c not in own]
        # every other image: empty sets; else a few absent shape classes and
        # ids beyond them verified absent, and one of its own classes
        # annotated not exhaustively
        neg = [] if i % 2 else sorted(
            set(rng.choice(absent, min(3, len(absent)), replace=False).tolist())
            | set(rng.randint(classes + 1, LVIS_V1_CATEGORIES + 1, 3).tolist()))
        not_exhaustive = [] if i % 2 or not own else [int(rng.choice(own))]
        stem = os.path.splitext(img["file_name"])[0]
        lvis_images.append({
            "id": img["id"], "height": img["height"], "width": img["width"],
            "coco_url": f"http://images.cocodataset.org/{coco_split}/{stem}.jpg",
            "neg_category_ids": [int(c) for c in neg],
            "not_exhaustive_category_ids": not_exhaustive,
        })
    categories = [{"id": c, "name": f"shape-{c - 1}" if c <= classes else f"lvis-{c}",
                   "frequency": FREQUENCIES[(c - 1) % 3]}
                  for c in range(1, LVIS_V1_CATEGORIES + 1)]
    out_dir = os.path.join(root, "lvis")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lvis_v1_{split}.json")
    with open(out, "w") as f:
        json.dump({"images": lvis_images, "annotations": coco["annotations"],
                   "categories": categories}, f)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--split", default="val", choices=("train", "val"))
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--classes", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    out = write_lvis(args.root, args.split, args.images, args.size, args.classes, args.seed)
    with open(out) as f:
        n_ann = len(json.load(f)["annotations"])
    print(f"{args.images} images, {n_ann} annotations -> {out}")


if __name__ == "__main__":
    main()
