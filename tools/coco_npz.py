#!/usr/bin/env python
"""Carry a COCO-format image dataset to a machine without an image decoder.

    python tools/coco_npz.py pack --root SRC --out FILE.npz
    python tools/coco_npz.py unpack FILE.npz --root DST

`pack` decodes every image of every split under `SRC/coco` (the splits that
`SRC/coco/annotations/instances_<split>.json` names) with cv2 and writes
them, with the annotation files, into one compressed `.npz`. `unpack` needs
numpy only: it writes each image as `DST/coco/<split>/<name>.npy` (an (H, W,
3) uint8 BGR array, which the port's `read_image` loads) and the annotation
files with their `file_name`s pointed at the `.npy` files, the layout that
`coco_2017_train` / `coco_2017_val` read with DETECTRON2_DATASETS=DST.

It lets the port train on the very pixels that a `.jpg` dataset holds, such
as the one `tools/make_synthetic_coco.py` writes for the JAX package.
"""

import argparse
import glob
import json
import os

import numpy as np


def pack(root: str, out: str) -> None:
    import cv2

    arrays = {}
    for ann in sorted(glob.glob(os.path.join(root, "coco", "annotations", "instances_*.json"))):
        split = os.path.basename(ann)[len("instances_"):-len(".json")]
        with open(ann) as f:
            data = json.load(f)
        for img in data["images"]:
            path = os.path.join(root, "coco", split, img["file_name"])
            pixels = cv2.imread(path, cv2.IMREAD_COLOR)
            if pixels is None:
                raise FileNotFoundError(f"cannot decode {path}")
            stem = os.path.splitext(img["file_name"])[0]
            arrays[f"{split}/{stem}"] = pixels
            img["file_name"] = stem + ".npy"
        arrays[f"annotations/{split}"] = np.frombuffer(json.dumps(data).encode(), np.uint8)
        print(f"{split}: {len(data['images'])} images")
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {os.path.getsize(out) / 2 ** 20:.1f} MiB")


def unpack(archive: str, root: str) -> None:
    with np.load(archive) as z:
        for key in z.files:
            kind, name = key.split("/", 1)
            if kind == "annotations":
                path = os.path.join(root, "coco", "annotations", f"instances_{name}.json")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    f.write(z[key].tobytes())
            else:
                path = os.path.join(root, "coco", kind, name + ".npy")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                np.save(path, z[key])
    print(f"unpacked {archive} into {root}/coco")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("pack")
    a.add_argument("--root", required=True)
    a.add_argument("--out", required=True)
    b = sub.add_parser("unpack")
    b.add_argument("archive")
    b.add_argument("--root", required=True)
    args = p.parse_args()
    if args.cmd == "pack":
        pack(args.root, args.out)
    else:
        unpack(args.archive, args.root)


if __name__ == "__main__":
    main()
