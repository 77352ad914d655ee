"""Panoptic Quality (PQ) in plain numpy: the port's own copy of
`mp_former_tpu/evaluation/panoptic_eval.py:21-147` (that module imports no
jax, but its package does), with its merge of other ranks' evaluators; with
panopticapi's pq_compute semantics and the quirks
`tests/test_panoptic_differential.py` pins.

PQ per class: sum of IoU(TP) / (|TP| + |FP|/2 + |FN|/2), a match at IoU > 0.5
(unique by construction); void is left out of the unions, and a predicted
segment mostly on void (or on a crowd region of its class) is no FP.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

VOID = 0


class PQStat:
    def __init__(self):
        self.iou = defaultdict(float)
        self.tp = defaultdict(int)
        self.fp = defaultdict(int)
        self.fn = defaultdict(int)

    def merge(self, other: "PQStat") -> None:
        for mine, theirs in ((self.iou, other.iou), (self.tp, other.tp),
                             (self.fp, other.fp), (self.fn, other.fn)):
            for k, v in theirs.items():
                mine[k] += v


class PanopticEvaluator:
    """Accumulate (pred_map, pred_segments, gt_map, gt_segments) pairs.

    Maps: (H, W) int32 segment ids (0 = void / unlabeled).
    segments: list of {"id", "category_id", "iscrowd"(gt only)}.
    """

    def __init__(self, is_thing: Optional[Dict[int, bool]] = None):
        self.is_thing = is_thing or {}
        self.reset()

    def reset(self):
        self._stat = PQStat()

    def merge_from(self, other: "PanopticEvaluator") -> None:
        self._stat.merge(other._stat)

    def process(self, pred_map: np.ndarray, pred_segments: List[dict],
                gt_map: np.ndarray, gt_segments: List[dict]):
        """panopticapi pq_compute_single_core semantics, pinned by
        tests/test_panoptic_differential.py: gt areas trusted from the
        segment dicts when present (panopticapi reads segments_info areas),
        unmatched non-crowd gt segments count FN even with zero map area,
        and the FP void-ignore rule uses ONE crowd label per category (the
        last in segments order — a panopticapi dict-overwrite quirk kept
        for score parity)."""
        stat = self._stat
        pred_cat = {s["id"]: s["category_id"] for s in pred_segments}
        gt_cat = {s["id"]: s["category_id"] for s in gt_segments}
        gt_crowd = {s["id"]: s.get("iscrowd", 0) for s in gt_segments}

        pred_map = pred_map.astype(np.uint64)
        gt_map = gt_map.astype(np.uint64)
        # joint histogram of (gt_id, pred_id) areas
        combined = gt_map * (2 ** 32) + pred_map
        ids, counts = np.unique(combined, return_counts=True)
        inter = {}
        for cid, cnt in zip(ids, counts):
            inter[(int(cid // 2 ** 32), int(cid % 2 ** 32))] = int(cnt)

        map_gt_area = defaultdict(int)
        pred_area = defaultdict(int)
        for (g, p), c in inter.items():
            map_gt_area[g] += c
            pred_area[p] += c
        gt_area = {s["id"]: s.get("area", map_gt_area[s["id"]])
                   for s in gt_segments}

        matched_gt, matched_pred = set(), set()
        for (g, p), c in inter.items():
            if g == VOID or p == VOID:
                continue
            if g not in gt_cat or p not in pred_cat:
                continue
            if gt_crowd.get(g, 0):
                continue
            if gt_cat[g] != pred_cat[p]:
                continue
            union = gt_area[g] + pred_area[p] - c - inter.get((VOID, p), 0)
            iou = c / union if union > 0 else 0.0
            if iou > 0.5:
                cat = gt_cat[g]
                stat.iou[cat] += iou
                stat.tp[cat] += 1
                matched_gt.add(g)
                matched_pred.add(p)

        crowd_label_by_cat = {}
        for s in gt_segments:
            g, cat = s["id"], s["category_id"]
            if g in matched_gt:
                continue
            if gt_crowd.get(g, 0):
                crowd_label_by_cat[cat] = g
                continue
            stat.fn[cat] += 1
        for p, cat in pred_cat.items():
            if p in matched_pred:
                continue
            area = pred_area.get(p, 0)
            if area == 0:
                continue
            ignored = inter.get((VOID, p), 0)
            if cat in crowd_label_by_cat:
                ignored += inter.get((crowd_label_by_cat[cat], p), 0)
            if ignored / area > 0.5:
                continue
            stat.fp[cat] += 1

    def evaluate(self) -> Dict[str, float]:
        stat = self._stat
        cats = set(stat.tp) | set(stat.fp) | set(stat.fn)

        def agg(selected):
            pq = sq = rq = 0.0
            n = 0
            for c in selected:
                tp, fp, fn = stat.tp[c], stat.fp[c], stat.fn[c]
                if tp + fp + fn == 0:
                    continue
                n += 1
                pq += stat.iou[c] / (tp + 0.5 * fp + 0.5 * fn)
                sq += (stat.iou[c] / tp) if tp else 0.0
                rq += tp / (tp + 0.5 * fp + 0.5 * fn)
            if n == 0:
                return {"PQ": float("nan"), "SQ": float("nan"), "RQ": float("nan"), "n": 0}
            return {"PQ": 100 * pq / n, "SQ": 100 * sq / n, "RQ": 100 * rq / n, "n": n}

        out = {"All": agg(cats)}
        if self.is_thing:
            out["Things"] = agg([c for c in cats if self.is_thing.get(c, False)])
            out["Stuff"] = agg([c for c in cats if not self.is_thing.get(c, True)])
        return {"panoptic_seg": out}
