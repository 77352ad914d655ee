"""SetCriterion: point-sampled mask classification losses (reference
modeling/criterion.py:90-320, `mp_former_tpu/models/criterion.py`).

Targets come padded to N slots with a validity mask; the matcher returns, per
image, the query assigned to every slot, and invalid pairs are left out of
every sum, which reproduces the reference's variable-length concatenation. DN
losses use identity indices per group (reference :248-266) and are normalised
by num_masks * scalar (:263). All matchings of a step (final + aux layers) are
solved in one host call.

The mask losses are the port's `grid` mode (`TPU.POINT_SAMPLE_MODE grid`
with `TPU.MAX_PAIRS > 0`, what the benchmark's configurations run): uncertainty
top-k over the prediction grid itself plus Bernoulli random extras, the
ground truth resized bilinearly to the prediction grid.

Where the JAX package compacts the valid (image, slot) pairs into a static
budget of `MAX_PAIRS` rows and samples with tent matrices (devices for static
shapes on its accelerator), the port selects the valid pairs with dynamic
shapes, at most `MAX_PAIRS` of them: the losses are the same sums over the
same pairs.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..structures import Targets
from ..utils.interp import resize
from .matcher import HungarianMatcher, lsa_host, uniform


def _valid_pairs(valid: torch.Tensor, max_pairs: int):
    """The valid (image, slot) pairs in row-major order, at most `max_pairs`
    where that is positive: (image index, slot index), each (P,)."""
    n = valid.shape[1]
    sel = valid.reshape(-1).nonzero()[:, 0]
    if max_pairs > 0:
        sel = sel[:max_pairs]
    return sel // n, sel % n


class SetCriterion:
    def __init__(self, num_classes: int, matcher: HungarianMatcher,
                 weight_dict: Dict[str, float], eos_coef: float, losses: List[str],
                 num_points: int, oversample_ratio: float, importance_sample_ratio: float,
                 dn_no_lb: bool = False, max_pairs: int = 0,
                 point_sample_mode: str = "grid"):
        if point_sample_mode != "grid" or max_pairs <= 0:
            raise ValueError("the reference runs the grid-mode mask losses alone: "
                             "TPU.POINT_SAMPLE_MODE grid with TPU.MAX_PAIRS > 0")
        self.num_classes = num_classes
        self.matcher = matcher
        self.weight_dict = weight_dict
        self.eos_coef = eos_coef
        self.losses = losses
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.dn_no_lb = dn_no_lb
        self.max_pairs = max_pairs
        # host seconds spent in scipy's assignment solver since the last reset
        self.matcher_host_seconds = 0.0

    # ------------------------------------------------------------------
    def _class_targets(self, pred_logits, qidx, labels, valid):
        """(B, Q) class targets: the matched slot's label, else no-object."""
        b, q, _ = pred_logits.shape
        target = torch.full((b, q), self.num_classes, dtype=torch.long,
                            device=pred_logits.device)
        bidx = torch.arange(b, device=valid.device)[:, None].expand_as(qidx)
        target[bidx[valid], qidx[valid]] = labels[valid].long()
        return target

    def _class_weight(self, pred_logits):
        weight = pred_logits.new_ones(self.num_classes + 1, dtype=torch.float32)
        weight[-1] = self.eos_coef
        return weight

    def loss_labels(self, pred_logits, qidx, labels, valid):
        """Weighted CE with no-object weight eos_coef (reference :127-144),
        torch's weighted mean. qidx (B, N): the query matched to each slot;
        invalid slots dropped."""
        target = self._class_targets(pred_logits, qidx, labels, valid)
        weight = self._class_weight(pred_logits)
        logits = pred_logits.float().transpose(1, 2)
        return {"loss_ce": F.cross_entropy(logits, target, weight)}

    # -- grid mode ---------------------------------------------------------
    def _make_grid_ctx(self, gt_masks, valid, hw):
        """The valid pairs and their ground truth resized to the prediction
        grid, shared by all layers."""
        sel_b, sel_n = _valid_pairs(valid, self.max_pairs)
        gt_rows = gt_masks[sel_b, sel_n % gt_masks.shape[1]].float()   # (P, H, W)
        gt_grid = resize(gt_rows, hw, "bilinear") if gt_rows.shape[0] else \
            gt_rows.new_zeros((0, *hw))
        return {"sel_b": sel_b, "sel_n": sel_n,
                "gt_grid": gt_grid.reshape(-1, hw[0] * hw[1])}

    def _loss_masks_grid(self, pred_masks, qidx, ctx, num_masks, generator=None):
        """Dense grid-point mask losses of one layer: uncertainty top-k over
        the prediction grid plus Bernoulli random extras (uniform draws (P, h*w)
        from `generator`)."""
        b, q, h, w = pred_masks.shape
        sel_b, sel_n = ctx["sel_b"], ctx["sel_n"]
        p = sel_b.shape[0]
        if p == 0:
            zero = pred_masks.sum() * 0.0
            return {"loss_mask": zero, "loss_dice": zero}
        logits = pred_masks[sel_b, qidx[sel_b, sel_n]].reshape(p, h * w).float()
        s = h * w
        num_uncertain = min(int(self.importance_sample_ratio * self.num_points), s)
        num_random = self.num_points - num_uncertain
        with torch.no_grad():
            unc = -logits.abs()
            # only the k-th value is needed (a threshold); above 2048 grid points
            # it is estimated on a strided subsample of 1024, as in the JAX package
            m = 1024
            if s > 2 * m:
                sub = unc[:, ::s // m][:, :m]
                kth = sub.topk(max(1, (num_uncertain * m) // s), dim=-1)[0][:, -1:]
            else:
                kth = unc.topk(num_uncertain, dim=-1)[0][:, -1:]
            rand = uniform(logits.shape, generator, logits.device)
            sel_mask = ((unc >= kth) | (rand < num_random / s)).float()
            cnt = sel_mask.sum(-1).clamp(min=1.0)
        labels = ctx["gt_grid"]
        bce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
        loss_mask = (bce * sel_mask).sum(-1) / cnt
        sig = logits.sigmoid() * sel_mask
        lab = labels * sel_mask
        dice = 1 - (2 * (sig * lab).sum(-1) + 1) / (sig.sum(-1) + lab.sum(-1) + 1)
        return {"loss_mask": loss_mask.sum() / num_masks, "loss_dice": dice.sum() / num_masks}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def layer_costs(self, outputs: Dict, targets: Targets, generator=None) -> torch.Tensor:
        """(L, B, Q, N) matcher costs of all layers, aux layers first, each
        with its own random points."""
        layer_outputs = outputs["aux_outputs"] + [outputs]
        targets = targets._replace(masks=targets.masks.float())  # once, not per layer
        return torch.stack([self.matcher.cost(o["pred_logits"], o["pred_masks"], targets,
                                              generator) for o in layer_outputs])

    def assign(self, costs: torch.Tensor) -> torch.Tensor:
        """(L, B, Q, N) costs -> (L, B, N) assignments, solved on the host in
        one call; the solver's host time is added to `matcher_host_seconds`."""
        l, b, q, n = costs.shape
        host = costs.detach().reshape(l * b, q, n).double().cpu().numpy()
        t0 = time.perf_counter()
        solved = lsa_host(host)
        self.matcher_host_seconds += time.perf_counter() - t0
        return torch.from_numpy(solved).reshape(l, b, n).to(costs.device)

    @staticmethod
    def _dn_layout(dn_out: Dict, targets: Targets):
        """The DN block's targets: the ground truth tiled `scalar` times with
        identity indices (reference :248-258), after the decoder's cut of the
        block to its first max_num slots. (targets, labels, valid, qidx,
        scalar)."""
        scalar = dn_out["dn_args"]["scalar"]
        n = dn_out["dn_args"]["max_num"]
        dn_targets = targets.first(n) if n < targets.num_instances else targets
        pad = scalar * n
        b = targets.labels.shape[0]
        dn_valid = dn_targets.valid.repeat(1, scalar)
        dn_qidx = torch.arange(pad, device=dn_valid.device)[None].expand(b, pad)
        return dn_targets, dn_targets.labels.repeat(1, scalar), dn_valid, dn_qidx, scalar

    def __call__(self, outputs: Dict, targets: Targets,
                 generator: Optional[torch.Generator] = None,
                 num_masks: Optional[torch.Tensor] = None,
                 assignments: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The full (unweighted) loss dict with the reference's key names.
        `num_masks` may be given (the number of valid instances of the global
        batch, reference :235-237); `assignments` (L, B, N) skips the matcher."""
        if num_masks is None:
            num_masks = targets.valid.sum().float().clamp(min=1.0)
        dn_out = outputs.get("dn_out")
        layer_outputs = outputs["aux_outputs"] + [outputs]
        num_layers = len(layer_outputs)
        if assignments is None:
            assignments = self.assign(self.layer_costs(outputs, targets, generator))

        if dn_out is not None:
            dn_targets, dn_labels, dn_valid, dn_qidx, scalar = self._dn_layout(dn_out, targets)
            dn_num_masks = num_masks * scalar
            dn_layers = dn_out["aux_outputs"] + [dn_out]

        with_masks = "masks" in self.losses
        main_ctx = dn_ctx = None
        if with_masks:
            hw = tuple(outputs["pred_masks"].shape[-2:])
            main_ctx = self._make_grid_ctx(targets.masks, targets.valid, hw)
            if dn_out is not None:
                # slot -> ground truth within the capped set, modulo its width
                dn_ctx = self._make_grid_ctx(dn_targets.masks, dn_valid, hw)

        losses: Dict[str, torch.Tensor] = {}
        for li, out in enumerate(layer_outputs):
            suffix = "" if li == num_layers - 1 else f"_{li}"
            d = {}
            if "labels" in self.losses:
                d.update(self.loss_labels(out["pred_logits"], assignments[li], targets.labels,
                                          targets.valid))
            if with_masks:
                d.update(self._loss_masks_grid(out["pred_masks"], assignments[li], main_ctx,
                                               num_masks, generator))
            losses.update({k + suffix: v for k, v in d.items()})
            if dn_out is not None:
                d = {}
                if "labels" in self.losses:
                    d.update(self.loss_labels(dn_layers[li]["pred_logits"], dn_qidx, dn_labels,
                                              dn_valid))
                if with_masks:
                    d.update(self._loss_masks_grid(dn_layers[li]["pred_masks"], dn_qidx, dn_ctx,
                                                   dn_num_masks, generator))
                losses.update({k + "_dn" + suffix: v for k, v in d.items()})
            else:
                zero = out["pred_logits"].new_zeros((), dtype=torch.float32)
                for k in ("loss_mask_dn", "loss_dice_dn", "loss_ce_dn"):
                    losses[k + suffix] = zero
        if self.dn_no_lb:
            losses = {k: v for k, v in losses.items() if not k.startswith("loss_ce_dn")}
        return losses

    def weighted_total(self, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Apply weight_dict and sum (reference maskformer_model.py:226-231)."""
        return sum(v * self.weight_dict[k] for k, v in losses.items() if k in self.weight_dict)


def build_criterion(cfg) -> SetCriterion:
    """Reference MaskFormer.from_config :116-146."""
    mf = cfg.MODEL.MASK_FORMER
    matcher = HungarianMatcher(cost_class=mf.CLASS_WEIGHT, cost_mask=mf.MASK_WEIGHT,
                               cost_dice=mf.DICE_WEIGHT, num_points=mf.TRAIN_NUM_POINTS)
    weight_dict = {"loss_ce": mf.CLASS_WEIGHT, "loss_mask": mf.MASK_WEIGHT,
                   "loss_dice": mf.DICE_WEIGHT, "loss_ce_dn": mf.CLASS_WEIGHT,
                   "loss_mask_dn": mf.MASK_WEIGHT, "loss_dice_dn": mf.DICE_WEIGHT}
    if mf.DEEP_SUPERVISION:
        aux = {}
        for i in range(mf.DEC_LAYERS - 1):
            aux.update({k + f"_{i}": v for k, v in weight_dict.items()})
        weight_dict.update(aux)
    return SetCriterion(
        cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, matcher=matcher, weight_dict=weight_dict,
        eos_coef=mf.NO_OBJECT_WEIGHT, losses=["labels", "masks"],
        num_points=mf.TRAIN_NUM_POINTS, oversample_ratio=mf.OVERSAMPLE_RATIO,
        importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO, dn_no_lb=mf.DN_NO_LB,
        max_pairs=cfg.TPU.MAX_PAIRS, point_sample_mode=cfg.TPU.POINT_SAMPLE_MODE)
