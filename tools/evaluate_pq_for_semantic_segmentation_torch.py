#!/usr/bin/env python
"""PQ of semantic-segmentation predictions (reference
tools/evaluate_pq_for_semantic_segmentation.py:21-40) on the PyTorch port's
evaluator; the twin of `tools/evaluate_pq_for_semantic_segmentation.py`,
without jax. Each class present in a map is one segment (stuff-style PQ).

    python tools/evaluate_pq_for_semantic_segmentation_torch.py \
        --pred-dir preds/ --gt-dir gts/ [--num-classes 150] [--ignore 255]

The maps are class-id images of the same name in both directories: `.npy`
((H, W) integers), or PNGs (their first channel) where cv2 is installed.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def to_segments(m: np.ndarray, num_classes: int, ignore: int):
    """(H, W) class ids -> (segment id map, segments): one segment a class
    present, id class + 1; the ignore label and ids >= num_classes are 0."""
    seg_map = np.zeros(m.shape, np.int64)
    segments = []
    for c in np.unique(m):
        if c == ignore or c >= num_classes:
            continue
        sid = int(c) + 1
        seg_map[m == c] = sid
        segments.append({"id": sid, "category_id": int(c), "iscrowd": 0})
    return seg_map, segments


def semantic_pq(pred_dir: str, gt_dir: str, num_classes: int = 150, ignore: int = 255):
    """(number of map pairs evaluated, the PanopticEvaluator summary)."""
    from mp_former_tpu_torch.data.dataset_mappers.mask_former_mappers import read_label_map
    from mp_former_tpu_torch.evaluation.panoptic_eval import PanopticEvaluator

    ev = PanopticEvaluator()
    n = 0
    for fname in sorted(os.listdir(pred_dir)):
        gt_path = os.path.join(gt_dir, fname)
        if not os.path.exists(gt_path):
            continue
        pm, ps = to_segments(read_label_map(os.path.join(pred_dir, fname)), num_classes, ignore)
        gm, gs = to_segments(read_label_map(gt_path), num_classes, ignore)
        ev.process(pm, ps, gm, gs)
        n += 1
    return n, ev.evaluate()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred-dir", required=True)
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--num-classes", type=int, default=150)
    p.add_argument("--ignore", type=int, default=255)
    args = p.parse_args(argv)
    n, res = semantic_pq(args.pred_dir, args.gt_dir, args.num_classes, args.ignore)
    print(f"evaluated {n} maps")
    print(res)


if __name__ == "__main__":
    main()
