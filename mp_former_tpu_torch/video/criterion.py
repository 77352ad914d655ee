"""The tube matcher and losses of video training (reference
mask2former_video/modeling/{criterion,matcher}.py; the port's copy of
`mp_former_tpu/video/criterion.py:25-122`), on the image criterion.

A query predicts a tube, (T, h, w) mask logits, and a target slot holds one,
(T, H, W). The matcher samples every frame at one set of random points an
image and flattens a tube's samples to T*P (matcher.py:113-133). The mask
losses fold T into the pair axis, pair (n, t) reading query qidx[n] at
frame t, valid where the tube is (criterion.py:140-186), and normalise by
the number of tubes. A slot may be invalid between valid ones (an object
absent from the sampled frames): nothing here assumes that real slots come
first. The class loss and `__call__` are the image criterion's, which take
`VideoTargets` as they are (it has no DN block to cut).
"""

from __future__ import annotations

import torch

from ..models.criterion import SetCriterion
from ..parallel.rows import draw
from ..models.matcher import (HungarianMatcher, batch_dice_cost, batch_sigmoid_ce_cost,
                              fill_invalid_columns, uniform)
from ..structures import VideoTargets
from ..utils.interp import point_sample


class VideoHungarianMatcher(HungarianMatcher):
    def cost(self, pred_logits, pred_masks, targets: VideoTargets, generator=None, coords=None):
        """pred_logits (B, Q, K+1), pred_masks (B, Q, T, h, w), targets.masks
        (B, N, T, H, W) -> (B, Q, N). The points are `coords` (B, num_points,
        2) where given, else drawn from `generator`; invalid columns cost just
        above the worst real cost of their clip."""
        b, q, t = pred_masks.shape[:3]
        n = targets.labels.shape[1]
        prob = pred_logits.float().softmax(-1)
        cc = -torch.gather(prob, 2, targets.labels[:, None, :].expand(-1, q, -1))
        if coords is None:
            coords = draw(lambda s: uniform(s, generator, pred_logits.device),
                          (b, self.num_points, 2), 0)
        pm = pred_masks.float().reshape(b, q * t, *pred_masks.shape[3:])
        out_pts = point_sample(pm.permute(0, 2, 3, 1), coords).transpose(1, 2)
        gm = targets.masks.float().reshape(b, n * t, *targets.masks.shape[3:])
        tgt_pts = point_sample(gm.permute(0, 2, 3, 1), coords).transpose(1, 2)
        out_pts = out_pts.reshape(b, q, t * self.num_points)
        tgt_pts = tgt_pts.reshape(b, n, t * self.num_points)
        cost = (self.cost_mask * batch_sigmoid_ce_cost(out_pts, tgt_pts)
                + self.cost_class * cc + self.cost_dice * batch_dice_cost(out_pts, tgt_pts))
        return fill_invalid_columns(cost, targets.valid)


class VideoSetCriterion(SetCriterion):
    def loss_masks_stacked(self, pred_masks, qidx, gt_masks, valid, num_masks, generator=None):
        """The T-fold of all layers: pred_masks (L, B, Q, T, h, w), qidx (L, B,
        N), gt_masks (B, N, T, H, W), valid (B, N) -> the image criterion's
        stacked random-point losses over the (B, N*T) pairs, pair n*T + t
        reading query qidx[n]*T + t, valid where its tube is."""
        l, b, q, t, h, w = pred_masks.shape
        n = qidx.shape[2]
        steps = torch.arange(t, dtype=qidx.dtype, device=qidx.device)
        qidx_t = (qidx[..., None] * t + steps).reshape(l, b, n * t)
        valid_t = valid[:, :, None].expand(b, n, t).reshape(b, n * t)
        return super().loss_masks_stacked(
            pred_masks.reshape(l, b, q * t, h, w), qidx_t,
            gt_masks.reshape(b, n * t, *gt_masks.shape[3:]), valid_t, num_masks, generator)


def build_video_criterion(cfg) -> VideoSetCriterion:
    """`mp_former_tpu/video/criterion.py:94-122`: the random-point loss
    whatever TPU.POINT_SAMPLE_MODE says (the grid loss is image-only in the
    JAX package), at most TPU.MAX_PAIRS (tube, frame) pairs, and the weights
    of the main and aux layers, with no DN keys."""
    mf = cfg.MODEL.MASK_FORMER
    matcher = VideoHungarianMatcher(cost_class=mf.CLASS_WEIGHT, cost_mask=mf.MASK_WEIGHT,
                                    cost_dice=mf.DICE_WEIGHT, num_points=mf.TRAIN_NUM_POINTS)
    weight_dict = {"loss_ce": mf.CLASS_WEIGHT, "loss_mask": mf.MASK_WEIGHT,
                   "loss_dice": mf.DICE_WEIGHT}
    if mf.DEEP_SUPERVISION:
        aux = {}
        for i in range(mf.DEC_LAYERS - 1):
            aux.update({k + f"_{i}": v for k, v in weight_dict.items()})
        weight_dict.update(aux)
    return VideoSetCriterion(
        cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, matcher=matcher, weight_dict=weight_dict,
        eos_coef=mf.NO_OBJECT_WEIGHT, losses=["labels", "masks"],
        num_points=mf.TRAIN_NUM_POINTS, oversample_ratio=mf.OVERSAMPLE_RATIO,
        importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO, max_pairs=cfg.TPU.MAX_PAIRS,
        point_sample_mode="random")

