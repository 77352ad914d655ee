"""COCO-style mask and box AP in plain numpy (no pycocotools): the COCOeval
algorithm with IoU matrices and crowd handling, greedy matching per IoU
threshold, 101-point precision interpolation, area ranges and maxDets.

The port's own copy of `mp_former_tpu/evaluation/coco_eval.py` (that module
imports no jax, but its package does), without the merge of per-rank
evaluators, which nothing in the port uses yet. `add_image`'s `eval_cats`
and `ignore_unmatched_cats` are LVIS's federated options (`lvis_eval.py`).
`COCOEvaluator` is the d2-protocol wrapper (reset / process / evaluate) of
`mp_former_tpu/evaluation/evaluators.py`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..native import polygons_to_mask

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def mask_iou(dets: List[np.ndarray], gts: List[np.ndarray],
             iscrowd: Sequence[bool]) -> np.ndarray:
    """IoU matrix (D, G) for bool masks; crowd gt: intersection / det area."""
    d, g = len(dets), len(gts)
    out = np.zeros((d, g), np.float64)
    if d == 0 or g == 0:
        return out
    det_flat = np.stack([m.reshape(-1) for m in dets]).astype(np.float64)
    gt_flat = np.stack([m.reshape(-1) for m in gts]).astype(np.float64)
    inter = det_flat @ gt_flat.T
    da = det_flat.sum(1)[:, None]
    ga = gt_flat.sum(1)[None, :]
    union = da + ga - inter
    crowd = np.asarray(iscrowd, bool)[None, :]
    denom = np.where(crowd, da, union)
    np.divide(inter, denom, out=out, where=denom > 0)
    return out


def box_iou(dets: np.ndarray, gts: np.ndarray, iscrowd: Sequence[bool]) -> np.ndarray:
    """xywh boxes."""
    d, g = len(dets), len(gts)
    out = np.zeros((d, g), np.float64)
    if d == 0 or g == 0:
        return out
    dx0, dy0 = dets[:, 0], dets[:, 1]
    dx1, dy1 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx0, gy0 = gts[:, 0], gts[:, 1]
    gx1, gy1 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.minimum(dx1[:, None], gx1[None]) - np.maximum(dx0[:, None], gx0[None])
    ih = np.minimum(dy1[:, None], gy1[None]) - np.maximum(dy0[:, None], gy0[None])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    da = (dets[:, 2] * dets[:, 3])[:, None]
    ga = (gts[:, 2] * gts[:, 3])[None]
    crowd = np.asarray(iscrowd, bool)[None, :]
    denom = np.where(crowd, da, da + ga - inter)
    np.divide(inter, denom, out=out, where=denom > 0)
    return out


class CocoAPEvaluator:
    """Accumulates per-image predictions/GT; computes COCOeval metrics.

    Per image call `add(image_id, category-keyed dets/gts)` where dets carry
    scores + masks (bool arrays) or boxes, and gts carry masks/boxes + iscrowd
    + area.
    """

    def __init__(self, iou_type: str = "segm", max_dets: int = 100):
        assert iou_type in ("segm", "bbox")
        self.iou_type = iou_type
        self.max_dets = max_dets
        # per (category) lists of per-image eval records
        self._records: Dict[int, List[dict]] = defaultdict(list)
        self._cats: set = set()
        self._acc_cache: Dict[str, np.ndarray] = {}

    def add_image(
        self,
        det_scores: np.ndarray,          # (D,)
        det_cats: np.ndarray,            # (D,) int
        det_masks_or_boxes,              # list of (H,W) bool | (D,4) xywh
        gt_cats: np.ndarray,             # (G,) int
        gt_masks_or_boxes,               # list of (H,W) bool | (G,4) xywh
        gt_iscrowd: np.ndarray,          # (G,) bool
        gt_areas: Optional[np.ndarray] = None,
        eval_cats: Optional[set] = None,              # LVIS federated: only these
        ignore_unmatched_cats: Optional[set] = None,  # LVIS not_exhaustive
    ):
        det_cats = np.asarray(det_cats)
        gt_cats = np.asarray(gt_cats)
        cats = set(det_cats.tolist()) | set(gt_cats.tolist())
        if eval_cats is not None:
            cats &= eval_cats
        self._cats |= cats
        self._acc_cache.clear()
        for c in cats:
            dsel = np.nonzero(det_cats == c)[0]
            gsel = np.nonzero(gt_cats == c)[0]
            # sort dets by score desc, cap maxDets
            order = dsel[np.argsort(-det_scores[dsel], kind="mergesort")][: self.max_dets]
            if self.iou_type == "segm":
                dets = [det_masks_or_boxes[i] for i in order]
                gts = [gt_masks_or_boxes[i] for i in gsel]
                if gt_areas is not None:
                    areas = gt_areas[gsel]
                else:
                    areas = np.array([m.sum() for m in gts], np.float64)
                ious = mask_iou(dets, gts, gt_iscrowd[gsel])
            else:
                dets = det_masks_or_boxes[order]
                gts = gt_masks_or_boxes[gsel]
                areas = (gts[:, 2] * gts[:, 3]) if gt_areas is None else gt_areas[gsel]
                ious = box_iou(dets, gts, gt_iscrowd[gsel])
            if self.iou_type == "segm":
                det_areas = np.array([m.sum() for m in dets], np.float64)
            else:
                det_areas = dets[:, 2] * dets[:, 3] if len(dets) else np.zeros(0)
            self._records[c].append({
                "scores": det_scores[order],
                "det_areas": det_areas,
                "ious": ious,
                "gt_crowd": gt_iscrowd[gsel].astype(bool),
                "gt_areas": np.asarray(areas, np.float64),
                "ignore_unmatched": bool(
                    ignore_unmatched_cats and c in ignore_unmatched_cats),
            })

    # ------------------------------------------------------------------
    def _evaluate_img(self, rec: dict, area_rng) -> dict:
        """Greedy matching per IoU threshold (COCOeval evaluateImg)."""
        lo, hi = area_rng
        gt_crowd = rec["gt_crowd"]
        gt_ignore = gt_crowd | (rec["gt_areas"] < lo) | (rec["gt_areas"] > hi)
        # sort gts: non-ignored first (COCO convention)
        gorder = np.argsort(gt_ignore, kind="mergesort")
        ious = rec["ious"][:, gorder]
        gig = gt_ignore[gorder]
        gcrowd = gt_crowd[gorder]
        d = ious.shape[0]
        g = ious.shape[1]
        t = len(IOU_THRS)
        dt_m = -np.ones((t, d), np.int64)
        gt_m = -np.ones((t, g), np.int64)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(d):
                best = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(g):
                    if gt_m[ti, gi] >= 0 and not gcrowd[gi]:
                        continue
                    if m > -1 and not gig[m] and gig[gi]:
                        break  # can't beat a non-ignored match with ignored
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_m[ti, di] = m
                gt_m[ti, m] = di
        # det ignore: matched to ignored gt, or unmatched + outside area range
        # (or unmatched entirely, for LVIS not-exhaustively-annotated images)
        da = rec["det_areas"]
        out_rng = (da < lo) | (da > hi)
        if rec.get("ignore_unmatched"):
            out_rng = np.ones_like(out_rng)
        dt_ig = np.zeros((t, d), bool)
        for ti in range(t):
            matched = dt_m[ti] >= 0
            if g == 0:
                dt_ig[ti] = out_rng
            else:
                dt_ig[ti] = np.where(matched, gig[np.clip(dt_m[ti], 0, None)],
                                     out_rng)
        return {
            "scores": rec["scores"],
            "dt_matched": dt_m >= 0,
            "dt_ignore": dt_ig,
            "num_gt": int((~gig).sum()),
        }

    def _accumulate(self, area: str = "all") -> np.ndarray:
        """precision (T, R, K) over categories present in GT. Memoized per
        area range: summarize() + per_category_ap() would otherwise re-run
        the greedy matching pass (the Python hot loop) a 5th time."""
        if area in self._acc_cache:
            return self._acc_cache[area]
        rng = AREA_RNGS[area]
        t = len(IOU_THRS)
        cats = sorted(self._cats)
        precision = -np.ones((t, len(REC_THRS), len(cats)))
        recall = -np.ones((t, len(cats)))
        for ki, c in enumerate(cats):
            evals = [self._evaluate_img(r, rng) for r in self._records[c]]
            npig = sum(e["num_gt"] for e in evals)
            if npig == 0:
                continue
            scores = np.concatenate([e["scores"] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            matched = np.concatenate([e["dt_matched"] for e in evals], axis=1)[:, order]
            ignored = np.concatenate([e["dt_ignore"] for e in evals], axis=1)[:, order]
            tps = np.logical_and(matched, ~ignored)
            fps = np.logical_and(~matched, ~ignored)
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for ti in range(t):
                tp, fp = tp_sum[ti], fp_sum[ti]
                rc = tp / npig
                pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                recall[ti, ki] = rc[-1] if len(rc) else 0
                # make precision monotone decreasing
                pr = pr.tolist()
                for i in range(len(pr) - 1, 0, -1):
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(len(REC_THRS))
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[ti, :, ki] = q
        self._acc_cache[area] = precision
        return precision

    def per_category_ap(self) -> Dict[int, float]:
        """AP per category over the 'all' area range (nan = no GT)."""
        p = self._accumulate("all")
        out = {}
        for ki, c in enumerate(sorted(self._cats)):
            pc = p[:, :, ki]
            valid = pc > -1
            out[c] = float(pc[valid].mean() * 100) if valid.any() else float("nan")
        return out

    def summarize(self) -> Dict[str, float]:
        res = {}
        for area, ap_key in (("all", "AP"), ("small", "APs"),
                             ("medium", "APm"), ("large", "APl")):
            p = self._accumulate(area)
            valid = p > -1
            res[ap_key] = float(p[valid].mean() * 100) if valid.any() else float("nan")
            if area == "all":
                p50 = p[0][p[0] > -1]
                p75 = p[5][p[5] > -1]
                res["AP50"] = float(p50.mean() * 100) if p50.size else float("nan")
                res["AP75"] = float(p75.mean() * 100) if p75.size else float("nan")
        return res


def rle_to_mask(rle: dict) -> np.ndarray:
    """Uncompressed COCO RLE ({"size": [h, w], "counts": [runs]}, column-major
    runs starting with background) -> (h, w) bool."""
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in rle["counts"]:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T.astype(bool)


class COCOEvaluator:
    """Mask AP over a dataset: `process` one image's predictions at a time,
    `evaluate` at the end. The ground truth comes from the records'
    annotations, whose `segmentation` is an (H, W) bool array, an uncompressed
    RLE dict or a polygon list."""

    def __init__(self, dataset_records: List[dict], max_dets: int = 100):
        self._gt_by_id = {r["image_id"]: r for r in dataset_records}
        self.max_dets = max_dets
        self.reset()

    def reset(self) -> None:
        self._ap = CocoAPEvaluator("segm", self.max_dets)

    def process(self, image_id, scores: np.ndarray, classes: np.ndarray,
                masks: Sequence[np.ndarray]) -> None:
        """Predictions at the image's original resolution."""
        rec = self._gt_by_id[image_id]
        h, w = rec["height"], rec["width"]
        gt_cats, gt_masks, gt_crowd, gt_areas = [], [], [], []
        for a in rec.get("annotations", []):
            seg = a.get("segmentation")
            if isinstance(seg, np.ndarray):
                m = seg.astype(bool)
            elif isinstance(seg, list):
                m = polygons_to_mask(seg, h, w)
            elif isinstance(seg, dict) and isinstance(seg.get("counts"), list):
                m = rle_to_mask(seg)
            else:
                continue
            gt_cats.append(a["category_id"])
            gt_masks.append(m)
            gt_crowd.append(bool(a.get("iscrowd", 0)))
            gt_areas.append(a.get("area", m.sum()))
        scores = np.asarray(scores)
        keep = scores > 0
        self._ap.add_image(
            det_scores=scores[keep],
            det_cats=np.asarray(classes)[keep],
            det_masks_or_boxes=[m for m, k in zip(masks, keep) if k],
            gt_cats=np.asarray(gt_cats, np.int64),
            gt_masks_or_boxes=gt_masks,
            gt_iscrowd=np.asarray(gt_crowd, bool),
            gt_areas=np.asarray(gt_areas, np.float64),
        )

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        return {"segm": self._ap.summarize()}
