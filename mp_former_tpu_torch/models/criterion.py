"""SetCriterion: point-sampled mask classification losses (reference
modeling/criterion.py:90-320, `mp_former_tpu/models/criterion.py`).

Targets come padded to N slots with a validity mask; the matcher returns, per
image, the query assigned to every slot, and invalid pairs are left out of
every sum, which reproduces the reference's variable-length concatenation. DN
losses use identity indices per group (reference :248-266) and are normalised
by num_masks * scalar (:263). All matchings of a step (final + aux layers) are
solved in one host call.

Two point-sampling modes, chosen as in the JAX package (`TPU.POINT_SAMPLE_MODE`,
and `grid` only where `TPU.MAX_PAIRS > 0`), so that a config selects the same
loss in both packages:

- `grid`: uncertainty top-k over the prediction grid itself plus Bernoulli
  random extras, the ground truth resized bilinearly to the prediction grid;
- `random`: the reference's continuous random points with 3x oversampling
  and uncertainty selection (point_rend), sampled with `grid_sample`.

Where the JAX package compacts the valid (image, slot) pairs into a static
budget of `MAX_PAIRS` rows and samples with tent matrices (devices for static
shapes on its accelerator), the port selects the valid pairs with dynamic
shapes, at most `MAX_PAIRS` of them, and samples with `grid_sample`: the
losses are the same sums over the same pairs.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..parallel.rows import RowShard, current_rows, draw, gather_rows
from ..structures import Targets
from ..utils.interp import point_sample, resize
from .matcher import HungarianMatcher, lsa_host, uniform


def sample_mask_points(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (P, h, w), coords (P, pts, 2) in [0, 1] as (x, y) -> (P, pts):
    bilinear samples with zero padding (grid_sample, align_corners=False)."""
    return point_sample(masks[..., None], coords)[..., 0]


def dice_loss(point_logits, point_labels, num_masks):
    """Reference dice_loss :21-44: (..., P, pts) -> (...), summed over the pairs."""
    inputs = point_logits.sigmoid()
    numerator = 2 * (inputs * point_labels).sum(-1)
    denominator = inputs.sum(-1) + point_labels.sum(-1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    return loss.sum(-1) / num_masks


def sigmoid_ce_loss(point_logits, point_labels, num_masks):
    """Reference sigmoid_ce_loss :47-66: (..., P, pts) -> (...), summed over the pairs."""
    loss = F.binary_cross_entropy_with_logits(point_logits, point_labels,
                                              reduction="none").mean(-1)
    return loss.sum(-1) / num_masks


def _valid_pairs(valid: torch.Tensor, max_pairs: int):
    """The valid (image, slot) pairs in row-major order, at most `max_pairs`
    where that is positive: (image index, slot index), each (P,), and the
    shard of the pairs that draws over them take (None in one process). In
    a distributed step (`parallel/rows.py`) the cap and the order are the
    global batch's, and this rank keeps the pairs of its rows."""
    n = valid.shape[1]
    shard = current_rows()
    full = gather_rows(valid)
    sel = full.reshape(-1).nonzero()[:, 0]
    if max_pairs > 0:
        sel = sel[:max_pairs]
    if shard is None:
        return sel // n, sel % n, None
    lo, hi = shard.start * n, (shard.start + shard.count) * n
    mine = sel[(sel >= lo) & (sel < hi)] - lo
    pairs = RowShard(total=int(sel.shape[0]), start=int((sel < lo).sum()),
                     count=int(mine.shape[0]))
    return mine // n, mine % n, pairs


def _uniform_pairs(shape, generator, device, axis: int, pairs: Optional[RowShard]):
    """`uniform` over `shape`, whose `axis` holds the pairs: this rank's of
    the global batch's draw where `pairs` is a shard."""
    return draw(lambda s: uniform(s, generator, device), shape, axis, pairs)


class SetCriterion:
    def __init__(self, num_classes: int, matcher: HungarianMatcher,
                 weight_dict: Dict[str, float], eos_coef: float, losses: List[str],
                 num_points: int, oversample_ratio: float, importance_sample_ratio: float,
                 dn_no_lb: bool = False, max_pairs: int = 0,
                 point_sample_mode: str = "random"):
        if point_sample_mode not in ("grid", "random"):
            raise ValueError(f"TPU.POINT_SAMPLE_MODE {point_sample_mode!r} is neither 'grid' "
                             "nor 'random'")
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
        self.point_sample_mode = point_sample_mode
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

    def loss_labels(self, pred_logits, qidx, labels, valid, norm=None):
        """Weighted CE with no-object weight eos_coef (reference :127-144).
        qidx (B, N): the query matched to each slot; invalid slots dropped.
        The weighted sum is divided by `norm` where given, else by the
        batch's own weight sum (torch's weighted mean)."""
        target = self._class_targets(pred_logits, qidx, labels, valid)
        weight = self._class_weight(pred_logits)
        logits = pred_logits.float().transpose(1, 2)
        if norm is None:
            return {"loss_ce": F.cross_entropy(logits, target, weight)}
        return {"loss_ce": F.cross_entropy(logits, target, weight, reduction="sum") / norm}

    # -- random mode -----------------------------------------------------
    def loss_masks_stacked(self, pred_masks, qidx, gt_masks, valid, num_masks, generator=None):
        """The random-point mask losses of all layers (reference loss_masks
        :146-191 per layer, point_rend's
        get_uncertain_point_coords_with_randomness).

        pred_masks (L, B, Q, h, w); qidx (L, B, N); gt_masks (B, M, H, W) with
        M == N or N % M == 0 (DN passes the untiled ground truth); valid
        (B, N). The draws, from `generator`: the oversampled points (L, P,
        num_sampled, 2), then the random extras (L, P, num_random, 2), over the
        valid pairs in row-major order. Returns {"loss_mask": (L,), "loss_dice": (L,)}."""
        l, b, q, h, w = pred_masks.shape
        gt_n = gt_masks.shape[1]
        sel_b, sel_n, pairs = _valid_pairs(valid, self.max_pairs)
        p = sel_b.shape[0]
        num_sampled = int(self.num_points * self.oversample_ratio)
        num_uncertain = int(self.importance_sample_ratio * self.num_points)
        num_random = self.num_points - num_uncertain
        device = pred_masks.device
        if p == 0:
            if pairs is not None and pairs.total:  # the other ranks draw: stay in step
                _uniform_pairs((l, 0, num_sampled, 2), generator, device, 1, pairs)
                if num_random > 0:
                    _uniform_pairs((l, 0, num_random, 2), generator, device, 1, pairs)
            zero = pred_masks.sum((1, 2, 3, 4)) * 0.0
            return {"loss_mask": zero, "loss_dice": zero}
        sel_q = qidx[:, sel_b, sel_n]                                  # (L, P)
        pred_rows = pred_masks[torch.arange(l, device=sel_q.device)[:, None],
                               sel_b[None], sel_q].float()             # (L, P, h, w)
        pred_rows = pred_rows.reshape(l * p, h, w)
        with torch.no_grad():
            coords1 = _uniform_pairs((l, p, num_sampled, 2), generator, device, 1, pairs)
            logits1 = sample_mask_points(pred_rows, coords1.reshape(l * p, num_sampled, 2))
            uncertainty = -logits1.abs().reshape(l, p, num_sampled)
            top = uncertainty.topk(num_uncertain, dim=-1)[1]
            coords = torch.gather(coords1, 2, top[..., None].expand(-1, -1, -1, 2))
            if num_random > 0:
                extra = _uniform_pairs((l, p, num_random, 2), generator, device, 1, pairs)
                coords = torch.cat([coords, extra], dim=2)
            pts = coords.shape[2]
            # the ground truth of a pair is the same in every layer
            gt_rows = gt_masks[sel_b, sel_n % gt_n].float()            # (P, H, W)
            point_labels = sample_mask_points(
                gt_rows, coords.transpose(0, 1).reshape(p, l * pts, 2))
            point_labels = point_labels.reshape(p, l, pts).transpose(0, 1)
        point_logits = sample_mask_points(pred_rows, coords.reshape(l * p, pts, 2))
        point_logits = point_logits.reshape(l, p, pts)
        return {"loss_mask": sigmoid_ce_loss(point_logits, point_labels, num_masks),
                "loss_dice": dice_loss(point_logits, point_labels, num_masks)}

    # -- grid mode ---------------------------------------------------------
    def _make_grid_ctx(self, gt_masks, valid, hw):
        """The valid pairs and their ground truth resized to the prediction
        grid, shared by all layers."""
        sel_b, sel_n, pairs = _valid_pairs(valid, self.max_pairs)
        gt_rows = gt_masks[sel_b, sel_n % gt_masks.shape[1]].float()   # (P, H, W)
        gt_grid = resize(gt_rows, hw, "bilinear") if gt_rows.shape[0] else \
            gt_rows.new_zeros((0, *hw))
        return {"sel_b": sel_b, "sel_n": sel_n, "pairs": pairs,
                "gt_grid": gt_grid.reshape(-1, hw[0] * hw[1])}

    def _loss_masks_grid(self, pred_masks, qidx, ctx, num_masks, generator=None):
        """Dense grid-point mask losses of one layer: uncertainty top-k over
        the prediction grid plus Bernoulli random extras (uniform draws (P, h*w)
        from `generator`)."""
        b, q, h, w = pred_masks.shape
        sel_b, sel_n, pairs = ctx["sel_b"], ctx["sel_n"], ctx["pairs"]
        p = sel_b.shape[0]
        if p == 0:
            if pairs is not None and pairs.total:  # the other ranks draw: stay in step
                _uniform_pairs((0, h * w), generator, pred_masks.device, 0, pairs)
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
            rand = _uniform_pairs(logits.shape, generator, logits.device, 0, pairs)
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

    @torch.no_grad()
    def class_weight_sums(self, outputs: Dict, targets: Targets,
                          assignments: torch.Tensor) -> torch.Tensor:
        """(L, 2): the weight sum of each layer's class loss over this batch's
        queries, main and DN (0 without DN): the denominators of the weighted
        means. A distributed step sums them over the ranks (`__call__`'s
        `class_norm`)."""
        layer_outputs = outputs["aux_outputs"] + [outputs]
        sums = torch.zeros((len(layer_outputs), 2), dtype=torch.float32,
                           device=outputs["pred_logits"].device)
        dn_out = outputs.get("dn_out")
        if dn_out is not None:
            _, dn_labels, dn_valid, dn_qidx, _ = self._dn_layout(dn_out, targets)
            dn_layers = dn_out["aux_outputs"] + [dn_out]
        for li, out in enumerate(layer_outputs):
            logits = out["pred_logits"]
            weight = self._class_weight(logits)
            target = self._class_targets(logits, assignments[li], targets.labels, targets.valid)
            sums[li, 0] = weight[target].sum()
            if dn_out is not None:
                logits = dn_layers[li]["pred_logits"]
                target = self._class_targets(logits, dn_qidx, dn_labels, dn_valid)
                sums[li, 1] = weight[target].sum()
        return sums

    def __call__(self, outputs: Dict, targets: Targets,
                 generator: Optional[torch.Generator] = None,
                 num_masks: Optional[torch.Tensor] = None,
                 assignments: Optional[torch.Tensor] = None,
                 class_norm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The full (unweighted) loss dict with the reference's key names.
        `num_masks` may be given (the number of valid instances of the global
        batch, reference :235-237); `assignments` (L, B, N) skips the matcher;
        `class_norm` (L, 2) divides each layer's weighted class loss, main
        and DN, where the batch's own weight sums should not (by default they
        do: torch's weighted mean)."""
        if num_masks is None:
            num_masks = targets.valid.sum().float().clamp(min=1.0)
        dn_out = outputs.get("dn_out")
        layer_outputs = outputs["aux_outputs"] + [outputs]
        num_layers = len(layer_outputs)
        if assignments is None:
            assignments = self.assign(self.layer_costs(outputs, targets, generator))
        norms = [(None, None)] * num_layers if class_norm is None else class_norm.unbind(0)

        if dn_out is not None:
            dn_targets, dn_labels, dn_valid, dn_qidx, scalar = self._dn_layout(dn_out, targets)
            dn_num_masks = num_masks * scalar
            dn_layers = dn_out["aux_outputs"] + [dn_out]

        use_grid = self.point_sample_mode == "grid" and self.max_pairs > 0
        with_masks = "masks" in self.losses
        stacked_main = stacked_dn = main_ctx = dn_ctx = None
        if with_masks and use_grid:
            hw = tuple(outputs["pred_masks"].shape[-2:])
            main_ctx = self._make_grid_ctx(targets.masks, targets.valid, hw)
            if dn_out is not None:
                # slot -> ground truth within the capped set, modulo its width
                dn_ctx = self._make_grid_ctx(dn_targets.masks, dn_valid, hw)
        elif with_masks:
            stacked_main = self.loss_masks_stacked(
                torch.stack([o["pred_masks"] for o in layer_outputs]), assignments,
                targets.masks, targets.valid, num_masks, generator)
            if dn_out is not None:
                stacked_dn = self.loss_masks_stacked(
                    torch.stack([o["pred_masks"] for o in dn_layers]),
                    dn_qidx[None].expand(num_layers, -1, -1), dn_targets.masks, dn_valid,
                    dn_num_masks, generator)

        losses: Dict[str, torch.Tensor] = {}
        for li, out in enumerate(layer_outputs):
            suffix = "" if li == num_layers - 1 else f"_{li}"
            d = {}
            if "labels" in self.losses:
                d.update(self.loss_labels(out["pred_logits"], assignments[li], targets.labels,
                                          targets.valid, norms[li][0]))
            if with_masks and use_grid:
                d.update(self._loss_masks_grid(out["pred_masks"], assignments[li], main_ctx,
                                               num_masks, generator))
            elif with_masks:
                d.update({k: v[li] for k, v in stacked_main.items()})
            losses.update({k + suffix: v for k, v in d.items()})
            if dn_out is not None:
                d = {}
                if "labels" in self.losses:
                    d.update(self.loss_labels(dn_layers[li]["pred_logits"], dn_qidx, dn_labels,
                                              dn_valid, norms[li][1]))
                if with_masks and use_grid:
                    d.update(self._loss_masks_grid(dn_layers[li]["pred_masks"], dn_qidx, dn_ctx,
                                                   dn_num_masks, generator))
                elif with_masks:
                    d.update({k: v[li] for k, v in stacked_dn.items()})
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
