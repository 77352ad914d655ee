"""Cityscapes official-protocol evaluators in numpy (the port's copy of
`mp_former_tpu/evaluation/cityscapes_eval.py`).

The reference dispatches cityscapes datasets to d2's
CityscapesInstanceEvaluator / CityscapesSemSegEvaluator (reference
train_net.py:187-204), which shell out to the official cityscapesscripts
(evalInstanceLevelSemanticLabeling / evalPixelLevelSemanticLabeling). Those
scripts are not installed with the port, so the protocols are implemented
here directly, in memory. The ground truth maps (`_gtFine_instanceIds`,
`_gtFine_labelIds`) are read by `read_label_map`: `.npy` where the path ends
so (the `.npy` rule of `data/datasets/register_all.py`), else decoded:

Instance AP (evalInstanceLevelSemanticLabeling semantics):
- 8 thing classes, overlaps 0.50:0.05:0.95, min region size 100 px.
- GT instances come from *_gtFine_instanceIds.png: ids >= 1000 encode
  (labelId * 1000 + instance); ids < 1000 are semantic regions — thing-class
  regions among them are crowd ("group") ignore regions.
- A GT matched by several predictions keeps the highest-score match; the
  other matches become false positives with their own scores. Unmatched
  predictions are ignored (not FP) when more than `overlap` of their pixels
  lie on void/ignored labels, same-class group regions, or same-class GT
  instances below the min region size.
- AP is the area under the score-swept precision/recall curve, averaged
  over overlaps and classes; AP50 is the overlap-0.5 slice.

Pixel-level IoU / iIoU (evalPixelLevelSemanticLabeling semantics):
- Confusion matrix over the 19 eval classes; FP for a class counts only
  predictions on pixels whose GT is another *evaluated* class (void GT
  pixels never count against predictions).
- iIoU reweights each GT instance's TP/FN pixels by
  (class average instance size / instance size), so small instances count
  as much as large ones; reported for the 8 instance classes and the
  category ("_sup") aggregation.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..data.dataset_mappers.mask_former_mappers import read_label_map
from ..data.datasets.cityscapes_labels import EVAL_LABELS, INSTANCE_LABELS, LABELS
from ..data.datasets.register_all import existing

_OVERLAPS = np.arange(0.5, 1.0, 0.05)
_MIN_REGION_SIZE = 100

# labelIds whose pixels are "void" for the instance protocol (ignored in eval)
_VOID_LABEL_IDS = frozenset(l.id for l in LABELS if l.ignoreInEval)


def _average_precision(y_true: np.ndarray, y_score: np.ndarray,
                       hard_fns: int) -> float:
    """Area under the precision/recall curve swept over score thresholds
    (cityscapesscripts evalInstanceLevelSemanticLabeling AP integration)."""
    n = len(y_true)
    n_pos = int(y_true.sum()) + hard_fns
    if n_pos == 0:
        return float("nan")
    if n == 0:
        return 0.0
    # official order: ascending score; one P/R point per distinct threshold
    # (tp = trues at-or-above it), plus the artificial last point (p=1, r=0)
    order = np.argsort(y_score, kind="stable")
    ys = y_score[order]
    yt = y_true[order].astype(np.float64)
    cum = np.concatenate([[0.0], np.cumsum(yt)])   # cum[i] = trues below idx i
    n_true = cum[-1]
    _, first = np.unique(ys, return_index=True)    # ascending thresholds
    tp = n_true - cum[first]
    fp = (n - first) - tp
    fn = cum[first] + hard_fns
    precision = np.concatenate([tp / np.maximum(tp + fp, 1e-12), [1.0]])
    recall = np.concatenate([tp / np.maximum(tp + fn, 1e-12), [0.0]])
    # official integration: midpoint step widths from a [-0.5, 0, 0.5]
    # convolution over recall padded with (recall[0], ..., 0) — NOT a
    # trapezoid; scores are then numerically comparable with
    # cityscapesscripts evalInstanceLevelSemanticLabeling
    recall_conv = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(recall_conv, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


class CityscapesInstanceEvaluator:
    """Accumulates per-image (gt, pred) intersections; evaluates at the end.

    `thing_index`: the model's class -> contiguous thing index (0..7), -1 for
    a class that is no thing; None where the model's classes are the thing
    indices already (the instance recipe's 8 classes). A panoptic model's 19
    trainIds need it (d2 maps a class through its name; the JAX package hands
    the trainIds on as they are, ROADMAP §C)."""

    def __init__(self, min_region_size: int = _MIN_REGION_SIZE,
                 thing_index: Optional[np.ndarray] = None):
        self.min_region_size = min_region_size
        self.thing_index = None if thing_index is None else np.asarray(thing_index, np.int64)
        self.reset()

    def reset(self):
        # per class: list of per-image dicts
        self._per_class: Dict[int, List[dict]] = {
            i: [] for i in range(len(INSTANCE_LABELS))}

    def merge_from(self, other: "CityscapesInstanceEvaluator") -> None:
        for c, recs in other._per_class.items():
            self._per_class[c].extend(recs)

    # ------------------------------------------------------------------
    def process(self, record: dict, scores: np.ndarray, classes: np.ndarray,
                masks: List[np.ndarray],
                gt_instance_map: Optional[np.ndarray] = None):
        """classes: contiguous thing index (0..7, trainId order); masks:
        bool (H, W) at original resolution. gt_instance_map overrides
        record['instance_id_file'] (for tests)."""
        if gt_instance_map is None:
            gt_instance_map = read_label_map(record["instance_id_file"])
            if gt_instance_map is None:
                raise FileNotFoundError(record["instance_id_file"])
        if self.thing_index is not None:
            classes = self.thing_index[np.asarray(classes, np.int64)]
        inst = gt_instance_map.astype(np.int64)
        label_map = np.where(inst >= 1000, inst // 1000, inst)
        void_mask = np.isin(label_map, list(_VOID_LABEL_IDS))

        for ci, lab in enumerate(INSTANCE_LABELS):
            cls_sel = np.asarray(classes) == ci
            p_masks = [m.astype(bool) for m, s in zip(masks, cls_sel) if s]
            p_scores = np.asarray(scores)[cls_sel]

            on_label = label_map == lab.id
            ids = np.unique(inst[on_label])
            real_ids = ids[ids >= 1000]
            # same-class crowd/"group" region (id == labelId < 1000)
            group_mask = on_label & (inst < 1000)

            gt_sizes = np.array(
                [(inst == gid).sum() for gid in real_ids], np.int64)
            inters = np.zeros((len(p_masks), len(real_ids)), np.int64)
            void_inter = np.zeros(len(p_masks), np.int64)
            group_inter = np.zeros(len(p_masks), np.int64)
            p_sizes = np.zeros(len(p_masks), np.int64)
            for pi, pm in enumerate(p_masks):
                p_sizes[pi] = pm.sum()
                void_inter[pi] = (pm & void_mask).sum()
                group_inter[pi] = (pm & group_mask).sum()
                sub = inst[pm]
                for gi, gid in enumerate(real_ids):
                    inters[pi, gi] = (sub == gid).sum()
            self._per_class[ci].append({
                "gt_sizes": gt_sizes, "pred_sizes": p_sizes,
                "pred_scores": p_scores, "inters": inters,
                "void_inter": void_inter, "group_inter": group_inter,
            })

    # ------------------------------------------------------------------
    def _class_ap(self, imgs: List[dict], overlap: float) -> float:
        y_true, y_score = [], []
        hard_fns = 0
        have_gt = False
        for im in imgs:
            valid_gt = im["gt_sizes"] >= self.min_region_size
            have_gt = have_gt or bool(valid_gt.any())
            iou = np.zeros_like(im["inters"], np.float64)
            if im["inters"].size:
                union = (im["gt_sizes"][None, :] + im["pred_sizes"][:, None]
                         - im["inters"])
                iou = im["inters"] / np.maximum(union, 1)
            # per valid gt: all preds over threshold are matches; best score
            # kept, the rest become FPs (cityscapesscripts duplicate rule)
            matched_pred = np.zeros(len(im["pred_sizes"]), bool)
            for gi in np.nonzero(valid_gt)[0]:
                over = np.nonzero(iou[:, gi] > overlap)[0]
                if len(over) == 0:
                    hard_fns += 1
                    continue
                matched_pred[over] = True
                ss = im["pred_scores"][over]
                best = np.argmax(ss)
                y_true.append(1.0)
                y_score.append(ss[best])
                for k, s in enumerate(ss):
                    if k != best:
                        y_true.append(0.0)
                        y_score.append(s)
            # unmatched predictions -> FP unless mostly on ignore pixels.
            # (a pred matching ANY gt above threshold was consumed above)
            small_gt = ~valid_gt
            for pi in range(len(im["pred_sizes"])):
                if matched_pred[pi] or im["pred_sizes"][pi] == 0:
                    continue
                ignore = im["void_inter"][pi] + im["group_inter"][pi]
                if small_gt.any():
                    ignore += int(im["inters"][pi, small_gt].sum())
                if ignore / im["pred_sizes"][pi] <= overlap:
                    y_true.append(0.0)
                    y_score.append(im["pred_scores"][pi])
        if not have_gt:
            return float("nan")
        return _average_precision(
            np.asarray(y_true), np.asarray(y_score), hard_fns)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        ap_matrix = np.full((len(INSTANCE_LABELS), len(_OVERLAPS)), np.nan)
        for ci, imgs in self._per_class.items():
            for oi, ov in enumerate(_OVERLAPS):
                ap_matrix[ci, oi] = self._class_ap(imgs, ov)
        with np.errstate(invalid="ignore"):
            per_class = np.nanmean(ap_matrix, axis=1)
            ap = float(np.nanmean(per_class)) if not np.all(
                np.isnan(per_class)) else float("nan")
            ap50_cols = ap_matrix[:, 0]
            ap50 = float(np.nanmean(ap50_cols)) if not np.all(
                np.isnan(ap50_cols)) else float("nan")
        res = {"AP": 100 * ap, "AP50": 100 * ap50}
        for ci, lab in enumerate(INSTANCE_LABELS):
            res[f"AP-{lab.name}"] = 100 * float(per_class[ci])
        return {"segm": res}


class CityscapesSemSegEvaluator:
    """Pixel-level IoU/iIoU over trainId predictions."""

    def __init__(self):
        self.reset()

    def reset(self):
        n = len(EVAL_LABELS)
        self._conf = np.zeros((n + 1, n + 1), np.int64)  # [gt, pred]; n=other
        self._i_tp = np.zeros(n, np.float64)  # filled at evaluate()
        self._i_fn = np.zeros(n, np.float64)
        # per-instance records for iIoU: (class, size, tp_pixels)
        self._instances: List[tuple] = []

    def merge_from(self, other: "CityscapesSemSegEvaluator") -> None:
        self._conf += other._conf
        self._instances.extend(other._instances)

    _label_id_to_train = None

    @classmethod
    def _lut(cls):
        if cls._label_id_to_train is None:
            lut = np.full(256, len(EVAL_LABELS), np.int64)
            for l in EVAL_LABELS:
                lut[l.id] = l.trainId
            cls._label_id_to_train = lut
        return cls._label_id_to_train

    def process(self, pred_trainid: np.ndarray, record: dict,
                gt_label_map: Optional[np.ndarray] = None,
                gt_instance_map: Optional[np.ndarray] = None):
        """pred_trainid: (H, W) in [0, 19). GT label/instance maps load from
        record['label_id_file'] / record['instance_id_file'] when not given;
        the sem-seg registration carries only the *_labelTrainIds path (`.png`
        or `.npy`), from which the sibling gtFine files are derived."""
        lab_path = record.get("label_id_file")
        inst_path = record.get("instance_id_file")
        sem_path = record.get("sem_seg_file_name") or ""
        for ext in (".png", ".npy"):
            key = "_gtFine_labelTrainIds" + ext
            if key not in sem_path:
                continue
            if not lab_path:
                lab_path = existing(sem_path.replace(key, "_gtFine_labelIds.png"))
            if not inst_path:
                p = existing(sem_path.replace(key, "_gtFine_instanceIds.png"))
                inst_path = p if os.path.isfile(p) else None
        if gt_label_map is None:
            gt_label_map = read_label_map(lab_path)
            if gt_label_map is None:
                raise FileNotFoundError(lab_path)
        if gt_instance_map is None and inst_path:
            gt_instance_map = read_label_map(inst_path)

        n = len(EVAL_LABELS)
        gt = self._lut()[np.clip(gt_label_map.astype(np.int64), 0, 255)]
        pred = np.clip(pred_trainid.astype(np.int64), 0, n - 1)
        self._conf += np.bincount(
            gt.reshape(-1) * (n + 1) + pred.reshape(-1),
            minlength=(n + 1) * (n + 1)).reshape(n + 1, n + 1)

        if gt_instance_map is not None:
            inst = gt_instance_map.astype(np.int64)
            for gid in np.unique(inst[inst >= 1000]):
                lab = int(gid // 1000)
                tid = int(self._lut()[lab]) if lab < 256 else n
                if tid >= n:
                    continue
                sel = inst == gid
                size = int(sel.sum())
                tp = int((pred[sel] == tid).sum())
                self._instances.append((tid, size, tp))

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        n = len(EVAL_LABELS)
        conf = self._conf
        tp = conf.diagonal()[:n].astype(np.float64)
        fn = conf[:n, :].sum(1) - tp
        # FP counts only predictions on *evaluated* gt pixels (void gt rows
        # excluded), per the official script
        fp = conf[:n, :n].sum(0) - tp
        iou = np.where(tp + fp + fn > 0, tp / np.maximum(tp + fp + fn, 1),
                       np.nan)

        # instance-weighted TP/FN per class
        i_tp = np.zeros(n)
        i_fn = np.zeros(n)
        sizes_by_class: Dict[int, List[int]] = {}
        for tid, size, _tp in self._instances:
            sizes_by_class.setdefault(tid, []).append(size)
        avg_size = {t: np.mean(s) for t, s in sizes_by_class.items()}
        for tid, size, tp_px in self._instances:
            w = avg_size[tid] / size
            i_tp[tid] += w * tp_px
            i_fn[tid] += w * (size - tp_px)
        has_inst = np.array(
            [l.hasInstances for l in EVAL_LABELS], bool)
        # NOTE: instance-weighted terms are FRACTIONAL — clamping the
        # denominator to 1 (as the integer IoU path may) understates iIoU
        # when the weighted denominator is in (0, 1); divide directly like
        # the official script (pinned by the semseg differential fuzz)
        i_denom = i_tp + fp + i_fn
        iiou = np.where(has_inst & (i_denom > 0),
                        i_tp / np.where(i_denom > 0, i_denom, 1), np.nan)

        # category ("_sup") aggregation
        cats = sorted({l.catId for l in EVAL_LABELS})
        iou_sup, iiou_sup = [], []
        for c in cats:
            sel = np.array([l.catId == c for l in EVAL_LABELS], bool)
            ctp, cfn = tp[sel].sum(), fn[sel].sum()
            # within-category confusion counts as TP for the category
            within = conf[np.ix_(sel, sel)].sum() - tp[sel].sum()
            ctp += within
            cfn -= within
            cfp = conf[:n, :n][:, sel].sum() - conf[np.ix_(sel, sel)].sum()
            iou_sup.append(ctp / (ctp + cfp + cfn)
                           if ctp + cfp + cfn > 0 else np.nan)
            if has_inst[sel].any():
                citp = i_tp[sel].sum()
                cifn = i_fn[sel].sum()
                cid = citp + cfp + cifn
                iiou_sup.append(citp / cid if cid > 0 else np.nan)
        with np.errstate(invalid="ignore"):
            return {"sem_seg": {
                "IoU": 100 * float(np.nanmean(iou)),
                "iIoU": 100 * float(np.nanmean(iiou[has_inst])),
                "IoU_sup": 100 * float(np.nanmean(iou_sup)),
                "iIoU_sup": 100 * float(np.nanmean(iiou_sup))
                if iiou_sup else float("nan"),
            }}
