#!/usr/bin/env python
"""Boundary AP (reference tools/evaluate_coco_boundary_ap.py through
boundary_iou_api) on the PyTorch port's evaluator; the twin of
`tools/evaluate_coco_boundary_ap.py`, without jax and without cv2.

Boundary IoU (Cheng et al.): the IoU of the masks' boundary regions, the
pixels within d = 0.02 x the image diagonal of the mask's contour. It
replaces the mask IoU of the port's numpy COCOeval.

    python tools/evaluate_coco_boundary_ap_torch.py --gt-json instances_val2017.json \
        --dt-json coco_instances_results.json [--max-images N]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def erode(mask: np.ndarray, iterations: int) -> np.ndarray:
    """cv2.erode of an (H, W) 0/1 uint8 map with a 3x3 square `iterations`
    times, cv2's default border (outside the map counts as 1), in numpy."""
    out = mask.astype(bool)
    for _ in range(iterations):
        for axis in (0, 1):
            padded = np.pad(out, [(1, 1) if a == axis else (0, 0) for a in (0, 1)],
                            constant_values=True)
            n = out.shape[axis]
            out = (padded.take(range(0, n), axis) & padded.take(range(1, n + 1), axis)
                   & padded.take(range(2, n + 2), axis))
    return out


def mask_to_boundary(mask: np.ndarray, dilation_ratio: float = 0.02) -> np.ndarray:
    """The boundary region of a binary mask (boundary_iou_api: erode by d on
    a map padded with one ring of 0, and keep what the erosion took)."""
    h, w = mask.shape
    d = max(int(round(dilation_ratio * np.sqrt(h * h + w * w))), 1)
    eroded = erode(np.pad(mask.astype(np.uint8), 1), d)[1:-1, 1:-1]
    return mask.astype(bool) & ~eroded


def boundary_ap(gt: dict, dts: list, max_images=None) -> dict:
    """The COCO summary keys as `boundary_<key>` of detections `dts` (COCO
    results: image_id, category_id, segmentation, score) against the COCO
    json `gt`."""
    from mp_former_tpu_torch.evaluation.coco_eval import CocoAPEvaluator, rle_to_mask
    from mp_former_tpu_torch.native import polygons_to_mask

    cats = sorted(gt["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    gt_by_img, dt_by_img = {}, {}
    for a in gt["annotations"]:
        gt_by_img.setdefault(a["image_id"], []).append(a)
    for d in dts:
        dt_by_img.setdefault(d["image_id"], []).append(d)

    def to_mask(seg, h, w):
        if isinstance(seg, list):
            return polygons_to_mask(seg, h, w)
        if isinstance(seg, dict) and isinstance(seg.get("counts"), list):
            return rle_to_mask(seg)
        raise ValueError("compressed RLE needs the native codec")

    ev = CocoAPEvaluator("segm")
    n = 0
    for img in gt["images"]:
        if max_images and n >= max_images:
            break
        h, w = img["height"], img["width"]
        g = gt_by_img.get(img["id"], [])
        d = dt_by_img.get(img["id"], [])
        if not g and not d:
            continue
        ev.add_image(
            det_scores=np.asarray([x["score"] for x in d], np.float64),
            det_cats=np.asarray([id_map[x["category_id"]] for x in d]),
            det_masks_or_boxes=[mask_to_boundary(to_mask(x["segmentation"], h, w)) for x in d],
            gt_cats=np.asarray([id_map[x["category_id"]] for x in g]),
            gt_masks_or_boxes=[mask_to_boundary(to_mask(x["segmentation"], h, w)) for x in g],
            gt_iscrowd=np.asarray([x.get("iscrowd", 0) for x in g], bool),
        )
        n += 1
    return {"boundary_" + k: v for k, v in ev.summarize().items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt-json", required=True)
    p.add_argument("--dt-json", required=True)
    p.add_argument("--max-images", type=int, default=None)
    args = p.parse_args(argv)
    with open(args.gt_json) as f:
        gt = json.load(f)
    with open(args.dt_json) as f:
        dts = json.load(f)
    print(json.dumps(boundary_ap(gt, dts, args.max_images)))


if __name__ == "__main__":
    main()
