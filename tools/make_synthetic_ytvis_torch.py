#!/usr/bin/env python
"""Generate a learnable synthetic YouTube-VIS video instance dataset for the
PyTorch port, with numpy and the port's polygon rasteriser only (no cv2, no
image codec), so that it runs where the port runs.

The distribution of `tools/make_synthetic_ytvis.py`: 2-5 shapes a video
whose class is their colour and kind (even classes ellipses, odd classes
rotated rectangles, `tools/make_synthetic_coco_torch.py`'s helpers) move and
spin smoothly across the frames over a low-frequency background; a shape
whose clipped outline is thinner than 4 pixels in a frame is absent there
(a null segmentation, as YouTube-VIS marks it). Frames are `.npy` (H, W, 3)
uint8 BGR arrays, painted with the rasteriser that turns the polygons into
ground truth; the json names each frame `<stem>.jpg`, which the port reads
from its `.npy` twin (`data/datasets/register_all.py:existing`). Every
second track's segmentations are compressed RLE strings (pycocotools'
`rleToString` of the rasterised polygon), the others polygons.

    python tools/make_synthetic_ytvis_torch.py --root /tmp/synth_vis \
        [--videos 40] [--frames 8 | --frames 2,5,36] [--size 320 | --height H --width W] \
        [--classes 10] [--split train] [--seed 0]

writes `$ROOT/ytvis_2019/<split>/JPEGImages/v<id>/<frame>.npy` and
`$ROOT/ytvis_2019/<split>.json`: with `--split train` the layout that
`ytvis_2019_train` reads, with `--split valid` that of `ytvis_2019_val`,
with DETECTRON2_DATASETS=$ROOT. A list of frame counts is cycled over the
videos.
"""

import argparse
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mp_former_tpu_torch.native import polygons_to_mask  # noqa: E402
from tools.make_synthetic_coco_torch import (class_color, ellipse_polygon,  # noqa: E402
                                             rotated_rect_polygon, smooth_background)


def rle_string(mask: np.ndarray) -> dict:
    """(h, w) bool -> a compressed COCO RLE {"size": [h, w], "counts": str}:
    column-major runs, background first, delta-coded against the run two
    back from the fourth on, in 5-bit chunks with a continuation bit, offset
    48 (pycocotools' rleToString)."""
    flat = mask.T.reshape(-1).astype(np.int8)
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]])).tolist()
    if flat.size and flat[0]:
        runs = [0] + runs
    out = bytearray()
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            out.append((c | 0x20 if more else c) + 48)
    return {"size": [int(mask.shape[0]), int(mask.shape[1])], "counts": out.decode("ascii")}


def write_dataset(root: str, videos: int = 40, frames=(8,), height: int = 320, width: int = 320,
                  classes: int = 10, split: str = "train", seed: int = 0) -> str:
    """Write the split; returns the path of its json. `frames`: the frame
    counts, cycled over the videos."""
    base = os.path.join(root, "ytvis_2019")
    img_root = os.path.join(base, split, "JPEGImages")
    rng = np.random.RandomState(seed)
    h, w = height, width
    s = min(h, w)
    video_list, annotations = [], []
    aid = 1
    for vi in range(videos):
        n_frames = frames[vi % len(frames)]
        vdir = f"v{vi + 1:04d}"
        os.makedirs(os.path.join(img_root, vdir), exist_ok=True)
        noise = rng.rand(max(h, w) // 16, max(h, w) // 16, 3)
        bg = smooth_background((noise * 80 + 40).astype(np.uint8), max(h, w))[:h, :w]
        objs = []
        for _ in range(rng.randint(2, 6)):
            c = int(rng.randint(classes))
            jitter = rng.randint(-25, 26, 3)
            objs.append({
                "c": c, "col": np.clip(class_color(c, classes) + jitter, 0, 255).astype(np.uint8),
                "cx": float(rng.randint(w // 6, 5 * w // 6)),
                "cy": float(rng.randint(h // 6, 5 * h // 6)),
                "vx": float(rng.randn() * s / 60), "vy": float(rng.randn() * s / 60),
                "ax": float(rng.randint(s // 16, s // 6)),
                "ay": float(rng.randint(s // 16, s // 6)),
                "ang": float(rng.rand() * np.pi), "spin": float(rng.randn() * 0.1),
                "rle": len(objs) % 2 == 1, "segs": [], "areas": [], "boxes": [],
            })
        fnames = []
        for fi in range(n_frames):
            img = bg.copy()
            for o in objs:
                cx, cy = o["cx"] + o["vx"] * fi, o["cy"] + o["vy"] * fi
                ang = o["ang"] + o["spin"] * fi
                if o["c"] % 2 == 0:
                    pts = ellipse_polygon(cx, cy, o["ax"], o["ay"], ang)
                else:
                    pts = rotated_rect_polygon(cx, cy, o["ax"] * 2, o["ay"] * 2, ang)
                pts[:, 0] = np.clip(pts[:, 0], 0, w - 1)
                pts[:, 1] = np.clip(pts[:, 1], 0, h - 1)
                x0, y0 = pts.min(0)
                x1, y1 = pts.max(0)
                polygon = pts.reshape(-1).tolist()
                mask = polygons_to_mask([polygon], h, w)
                if (x1 - x0) < 4 or (y1 - y0) < 4 or not mask.any():
                    for k in ("segs", "areas", "boxes"):
                        o[k].append(None)
                    continue
                img[mask] = o["col"]
                o["segs"].append(rle_string(mask) if o["rle"] else [polygon])
                o["areas"].append(float(mask.sum()))
                o["boxes"].append([float(x0), float(y0), float(x1 - x0), float(y1 - y0)])
            np.save(os.path.join(img_root, vdir, f"{fi:05d}.npy"), img)
            fnames.append(f"{vdir}/{fi:05d}.jpg")
        video_list.append({"id": vi + 1, "width": w, "height": h, "length": n_frames,
                           "file_names": fnames})
        for o in objs:
            if not any(a is not None for a in o["areas"]):
                continue
            annotations.append({"id": aid, "video_id": vi + 1, "category_id": o["c"] + 1,
                                "iscrowd": 0, "segmentations": o["segs"], "areas": o["areas"],
                                "bboxes": o["boxes"]})
            aid += 1
    data = {"videos": video_list, "annotations": annotations,
            "categories": [{"id": c + 1, "name": f"shape_{c}"} for c in range(classes)]}
    out = os.path.join(base, f"{split}.json")
    with open(out, "w") as f:
        json.dump(data, f)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--videos", type=int, default=40)
    p.add_argument("--frames", default="8", help="frames a video, or a comma list cycled over "
                                                 "the videos")
    p.add_argument("--size", type=int, default=320, help="height and width")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--split", default="train")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    frames = tuple(int(f) for f in args.frames.split(","))
    out = write_dataset(args.root, args.videos, frames, args.height or args.size,
                        args.width or args.size, args.classes, args.split, args.seed)
    with open(out) as f:
        n_ann = len(json.load(f)["annotations"])
    print(f"wrote {args.videos} videos / {n_ann} tracks -> {out}")


if __name__ == "__main__":
    main()
