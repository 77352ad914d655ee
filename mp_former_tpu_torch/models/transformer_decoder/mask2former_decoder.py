"""Mask2Former / MP-Former MaskDN transformer decoder
(`mp_former_tpu/models/transformer_decoder/mask2former_decoder.py`).

At inference the MaskDN decoder is plain Mask2Former (reference
mask2former_transformer_decoder.py:1779-1856): learnable queries, 9 layers
that cycle over the 3 scales (`i % 3`), each masked cross-attention ->
self-attention -> FFN, with the next layer's attention mask taken from the
current mask prediction (bilinear resize to the next level, sigmoid < 0.5,
the same mask for every head). A row whose keys are all blocked attends
everywhere instead (reference :1780). `PRE_NORM` makes the layers pre-norm;
`LAST_Q_RATIO` r > 0 (the LYSmooth decoder, reference :3226-3240) carries an
EMA of the mask embeddings across the layers, r * previous + (1 - r) * new,
the carried value detached.

In training (`dn_args` given) MP-Former's mask-piloted queries are put in
front of the learnable ones: `scalar` groups of N queries, one per padded
ground-truth slot; a self-attention mask keeps the groups apart and hides
them from the learnable queries (:1051-1059). Slots without an instance carry
zero content and fully blocked rows, and the losses leave them out.
`DN_MODE` picks the content and the cross-attention masks of the DN rows, as
the JAX decoder does (its `:331-470`):
- `points` (the released recipe's, reference `prepare_for_dn_v5` :968) and
  `mask`: the area-downsampled ground truth, each entry flipped with a
  probability proportional to the mask's area (`gen_mask_dn` :1584-1622),
  per head under `HEAD_DN`;
- `shift`, `scale`, `shift_scale`, `patch`, `points_MAE` (v6-v9,
  :1063-1580, the "static3" modes): the ground truth noised once at the 1/8
  level and nearest-downsampled to the coarser ones, fixed for the forward
  and shared by the heads (`HEAD_DN` is not read);
- `lb` (nearest-downsampled ground truth, multiplicative noise on the label
  embedding) and `base` (the mask-averaged pixel features as content): with
  `mask`, the JAX package's working reconstructions of code that is dead
  upstream.
The label embeddings are class-flipped (`LB_NOISE_RATIO`) in `points` and the
static3 modes. `points` and the static3 modes put fresh ground-truth masks
into the DN rows at every layer under ALL_LY_DN (else the first three);
under `base`, `lb` and `mask` the DN rows take the model's own predicted
masks from layer 1 on. The noise is drawn from the forward's `generator`
through `models/matcher.py:uniform`, in the JAX decoder's order: the static3
noise, the label flips and their values, the content noise of `base` / `lb`
/ `shift`, then one point-noise tensor a refresh. Every draw has the batch
first; a distributed step draws the global batch's and keeps its rows
(`parallel/rows.py`).

The attention mask is (B, Q, S), shared by the heads, where every row's mask
is; with per-head DN rows (`HEAD_DN` in `points` / `mask`) it is
(B, H, Q, S). K3 takes both.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ...parallel.rows import draw
from ...structures import DNArgs
from ...utils import float32_region, region_dtype
from ...utils.interp import resize
from ...utils.layers import Conv2d, LayerNorm, c2_xavier_fill
from ...utils.registry import TRANSFORMER_DECODER_REGISTRY
from .position_encoding import position_embedding_sine
from ..matcher import uniform
from .primitives import MLP, CrossAttentionLayer, FFNLayer, SelfAttentionLayer

# v6-v9: noised once at the 1/8 level, fixed for the forward
STATIC3_MODES = ("shift", "scale", "shift_scale", "patch", "points_MAE")
DN_MODES = ("points", "lb", "mask", "base") + STATIC3_MODES
# the modes whose DN rows get fresh ground-truth masks in refreshed layers (JAX :506-511)
_REFRESH_MODES = ("points",) + STATIC3_MODES



def _uniform_rows(shape, generator, device) -> torch.Tensor:
    """`uniform` over a batch-first `shape`: in a distributed step this
    rank's rows of the global batch's draw (`parallel/rows.py`)."""
    return draw(lambda s: uniform(s, generator, device), shape, 0)

def build_transformer_decoder(cfg, in_channels):
    """Registry dispatch (reference maskformer_transformer_decoder.py:22-27)."""
    name = cfg.MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME
    return TRANSFORMER_DECODER_REGISTRY.get(name).from_config(cfg, in_channels)


def _dn_tgt_mask(scalar: int, single_pad: int, num_queries: int) -> torch.Tensor:
    """(T, T) bool self-attention mask, True = blocked (reference :1051-1059):
    the learnable queries do not see the DN queries, and a DN group sees only
    itself and the learnable queries."""
    pad = scalar * single_pad
    m = torch.zeros((pad + num_queries, pad + num_queries), dtype=torch.bool)
    m[pad:, :pad] = True
    for g in range(scalar):
        m[g * single_pad:(g + 1) * single_pad, (g + 1) * single_pad:pad] = True
        m[g * single_pad:(g + 1) * single_pad, :g * single_pad] = True
    return m


def _with_dn_rows(attn_mask: torch.Tensor, dn_rows: torch.Tensor) -> torch.Tensor:
    """The attention mask (B, Q, S) with its first `pad` rows replaced by
    `dn_rows` (B, 1 or H, pad, S): (B, Q, S) where the DN rows are shared by
    the heads, else (B, H, Q, S)."""
    pad = dn_rows.shape[2]
    if dn_rows.shape[1] == 1:
        return torch.cat([dn_rows[:, 0], attn_mask[:, pad:]], dim=1)
    rest = attn_mask[:, None, pad:].expand(-1, dn_rows.shape[1], -1, -1)
    return torch.cat([dn_rows, rest], dim=2)


def _scatter_fg(val: torch.Tensor, dest_r: torch.Tensor, dest_c: torch.Tensor,
                h: int, w: int) -> torch.Tensor:
    """A blank (S, h, w) canvas with val (S, a, b) written at (dest_r,
    dest_c), each (S, a, b) and clamped into the canvas, as a max: pixels that
    land on one place OR together, so those pushed out pile up on the border
    (JAX :138-144, reference :1113-1125)."""
    n = val.shape[0]
    base = torch.arange(n, device=val.device)[:, None, None] * (h * w)
    flat = (base + dest_r * w + dest_c).reshape(-1)
    canvas = torch.zeros(n * h * w, dtype=torch.float32, device=val.device)
    canvas.index_put_((flat,), val.reshape(-1).float(), accumulate=True)
    return canvas.view(n, h, w) > 0


def static3_blocked(mode: str, fg: torch.Tensor, boxes: torch.Tensor, noise_scale: float,
                    dn_ratio: float, size_list, generator) -> List[torch.Tensor]:
    """The static3 modes' blocked masks (JAX `_static3_blocked` :118-240).
    fg (S, h8, w8) bool: the ground truth nearest-downsampled to the finest
    level size_list[-1] (1/8), one row a DN query; boxes (S, 4) cxcywh.
    Returns [(S, h_l, w_l) bool] in size_list order, True = blocked."""
    n, h8, w8 = fg.shape
    device = fg.device
    rr = torch.arange(h8, device=device)[:, None]
    cc = torch.arange(w8, device=device)[None]
    half = torch.stack([boxes[:, 2] / 2, boxes[:, 3] / 2], -1)
    if mode == "shift":
        # v6 (:1098-1128). Quirk kept: the row shift comes from the box width,
        # the column shift from its height, both scaled by the grid *width*
        delta = (_uniform_rows((n, 2), generator, device) * 2 - 1) * half * noise_scale * w8
        dr = torch.floor(delta[:, 0]).long()[:, None, None]
        dc = torch.floor(delta[:, 1]).long()[:, None, None]
        dest_r = (rr[None] + dr).clamp(0, h8 - 1).expand(n, h8, w8)
        dest_c = (cc[None] + dc).clamp(0, w8 - 1).expand(n, h8, w8)
        blk8 = ~_scatter_fg(fg, dest_r, dest_c, h8, w8)
    elif mode in ("scale", "shift_scale"):
        # v7 (:1227-1266): with probability 1 - DN_RATIO the mask grows by
        # 1 + noise_scale about its box centre; shift_scale also shifts as v6
        sh, sw = int(h8 * (1 + noise_scale)) + 1, int(w8 * (1 + noise_scale)) + 1
        is_scale = (_uniform_rows((n,), generator, device) > dn_ratio)[:, None, None]
        # the centre offsets truncate toward zero (torch .long())
        dc0 = ((h8 - sh) * boxes[:, 0]).to(torch.int32).long()[:, None, None]
        dc1 = ((w8 - sw) * boxes[:, 1]).to(torch.int32).long()[:, None, None]
        ii = torch.arange(sh, device=device)[:, None]
        jj = torch.arange(sw, device=device)[None]
        val_scaled = fg[:, (ii * h8 // sh).clamp(max=h8 - 1), (jj * w8 // sw).clamp(max=w8 - 1)]
        in_plain = (ii < h8) & (jj < w8)
        val_plain = fg[:, ii.clamp(max=h8 - 1), jj.clamp(max=w8 - 1)] & in_plain
        val = torch.where(is_scale, val_scaled, val_plain)
        base_r = torch.where(is_scale, ii + dc0, ii).float()
        base_c = torch.where(is_scale, jj + dc1, jj).float()
        if mode == "shift_scale":
            delta = (_uniform_rows((n, 2), generator, device) * 2 - 1) * half * noise_scale * w8
            base_r = base_r + delta[:, 0, None, None]
            base_c = base_c + delta[:, 1, None, None]
        # the destinations floor after the clamp
        dest_r = torch.floor(base_r.clamp(0, h8 - 1)).long().expand(n, sh, sw)
        dest_c = torch.floor(base_c.clamp(0, w8 - 1)).long().expand(n, sh, sw)
        blk8 = ~_scatter_fg(val, dest_r, dest_c, h8, w8)
    elif mode == "patch":
        # v8 (:1371-1390): one rectangle of about noise_scale x the mask's
        # area opened, with a random aspect at a random place
        area = (fg.sum((1, 2)).float() * noise_scale).clamp(min=1.0)
        u_short, u_aspect, u_row, u_col = (_uniform_rows((n,), generator, device)
                                            for _ in range(4))
        short = (torch.floor(u_short * torch.floor(torch.sqrt(area))) + 1).to(torch.int32)
        long = torch.floor(area / short).to(torch.int32)
        ph = torch.where(u_aspect < 0.5, short, long.clamp(max=h8))
        pw = torch.where(u_aspect < 0.5, long.clamp(max=w8), short)
        x0 = torch.floor(u_row * (h8 - ph + 1).clamp(min=1)).to(torch.int32)
        y0 = torch.floor(u_col * (w8 - pw + 1).clamp(min=1)).to(torch.int32)
        x0, y0, ph, pw = (t[:, None, None] for t in (x0, y0, ph, pw))
        rect = (rr >= x0) & (rr < x0 + ph) & (cc >= y0) & (cc < y0 + pw)
        blk8 = ~fg & ~rect
    elif mode == "points_MAE":
        # v9 (:1489-1518): each level blocked where an entry of noise_scale
        # probability falls, drawn a level, finest first, on the un-noised
        # chain of nearest downsamples
        levels, chain = [], ~fg
        for h, w in reversed(size_list):
            if (h, w) != (h8, w8):
                chain = resize(chain.float(), (h, w), "nearest") > 0.5
            levels.append(chain | (_uniform_rows(chain.shape, generator, device) < noise_scale))
        return levels[::-1]
    else:
        raise ValueError(f"{mode!r} is not a static3 DN mode {STATIC3_MODES}")
    # the coarser levels are nearest downsamples of the noised 1/8 mask (v6 :1130-1137)
    return [blk8 if (h, w) == (h8, w8) else resize(blk8.float(), (h, w), "nearest") > 0.5
            for h, w in size_list]


@TRANSFORMER_DECODER_REGISTRY.register()
class MultiScaleMaskedTransformerDecoderMaskDN(nn.Module):
    # the MaskDN decoder carries the DN label embedding (unused at inference)
    has_label_enc = True
    # query embeddings x per-pixel mask embeddings -> mask logits
    mask_product = "bqc,bchw->bqhw"

    def __init__(self, in_channels: int, *, num_classes: int, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, pre_norm: bool = False, mask_dim: int = 256,
                 enforce_input_project: bool = False, num_feature_levels: int = 3,
                 dn_mode: str = "points", head_dn: bool = False, all_lys: bool = False,
                 dn_ratio: float = 0.5, dn_label_noise_ratio: float = -1.0,
                 last_q_ratio: float = 0.0, dn_max_gt: int = 0):
        super().__init__()
        if self.has_label_enc and dn_mode not in DN_MODES:
            raise ValueError(f"MODEL.MASK_FORMER.DN_MODE {dn_mode!r} is none of {DN_MODES}")
        self.hidden_dim, self.num_classes = hidden_dim, num_classes
        self.num_queries, self.nheads = num_queries, nheads
        self.dn_mode, self.head_dn, self.all_lys = dn_mode, head_dn, all_lys
        self.dn_ratio, self.last_q_ratio = dn_ratio, last_q_ratio
        self.dn_label_noise_ratio, self.dn_max_gt = dn_label_noise_ratio, dn_max_gt
        self.num_layers, self.num_feature_levels = dec_layers, num_feature_levels
        # no dropout: the JAX decoder hard-codes 0.0 here (its :281-294)
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, nheads, normalize_before=pre_norm)
            for _ in range(dec_layers))
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, nheads, normalize_before=pre_norm)
            for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim, dim_feedforward, normalize_before=pre_norm)
            for _ in range(dec_layers))
        self.decoder_norm = LayerNorm(hidden_dim)
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(num_feature_levels, hidden_dim)
        self.input_proj = nn.ModuleList()
        for _ in range(num_feature_levels):
            if in_channels != hidden_dim or enforce_input_project:
                conv = Conv2d(in_channels, hidden_dim, kernel_size=1)
                c2_xavier_fill(conv)
                self.input_proj.append(conv)
            else:
                self.input_proj.append(nn.Sequential())
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)
        if self.has_label_enc:
            self.label_enc = nn.Embedding(num_classes, hidden_dim)

    @classmethod
    def from_config(cls, cfg, in_channels, **extra):
        """The decoder `cfg` describes; `extra` goes to the constructor as it
        is (a subclass's own arguments). The vanilla and video decoders read
        no LAST_Q_RATIO, as their JAX twins' `from_config`."""
        mf = cfg.MODEL.MASK_FORMER
        return cls(
            in_channels,
            num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
            hidden_dim=mf.HIDDEN_DIM,
            num_queries=mf.NUM_OBJECT_QUERIES,
            nheads=mf.NHEADS,
            dim_feedforward=mf.DIM_FEEDFORWARD,
            dec_layers=mf.DEC_LAYERS - 1,  # reference from_config: one is the query loss
            pre_norm=mf.PRE_NORM,
            mask_dim=cfg.MODEL.SEM_SEG_HEAD.MASK_DIM,
            enforce_input_project=mf.ENFORCE_INPUT_PROJ,
            dn_mode=mf.DN_MODE,
            head_dn=mf.HEAD_DN,
            all_lys=mf.ALL_LY_DN,
            dn_ratio=mf.DN_RATIO,
            dn_label_noise_ratio=mf.LB_NOISE_RATIO,
            last_q_ratio=mf.LAST_Q_RATIO if cls.has_label_enc else 0.0,
            dn_max_gt=cfg.TPU.DN_MAX_GT,
            **extra,
        )

    def forward_prediction_heads(self, output: torch.Tensor, mask_features: torch.Tensor,
                                 attn_mask_target_size, smooth: Optional[list] = None):
        """(B, Q, C) queries -> class logits (B, Q, K+1), mask logits
        (B, Q, H/4, W/4) and the next attention mask (B, Q, h*w) bool,
        True = blocked, shared by the heads (reference :1859-1877); with the
        video decoder's clips of T frames (`mask_product`) the masks are
        (B, Q, T, H/4, W/4) and the attention mask (B, Q, T*h*w). `smooth`, a
        one-entry list, carries LYSmooth's detached mask embeddings from call
        to call (JAX :313-323)."""
        dec = self.decoder_norm(output)
        outputs_class = self.class_embed(dec)
        mask_embed = self.mask_embed(dec)
        if smooth is not None:
            r = self.last_q_ratio
            if smooth[0] is not None:
                mask_embed = r * smooth[0] + (1.0 - r) * mask_embed
            smooth[0] = mask_embed.detach()
        outputs_mask = torch.einsum(self.mask_product, mask_embed, mask_features)
        # the JAX package (`mask2former_decoder.py:325-327`) resizes the mask
        # logits in their own type and thresholds the sigmoid there: in
        # bfloat16 a logit within ~0.004 below 0 rounds to a sigmoid of 0.5,
        # which does not block
        with float32_region(outputs_mask.device.type):
            attn_mask = resize(outputs_mask, attn_mask_target_size, "bilinear")
            attn_mask = attn_mask.sigmoid().flatten(2) < 0.5
        return outputs_class, outputs_mask, attn_mask

    def _prepare_dn(self, dn_args: DNArgs, size_list, mask_features: torch.Tensor, generator):
        """The DN block (JAX :344-476): (content (B, pad, C), (T, T)
        self-attention mask, a function level -> the DN rows' blocked mask
        (B, 1 or H, pad, S_l), the meta dict the criterion reads)."""
        targets = dn_args.targets
        cap = targets.num_instances
        if self.dn_max_gt > 0:
            cap = min(cap, self.dn_max_gt)
        if dn_args.batch_max is not None:
            # NUM_DN >= 100: the reference pads to the batch's largest instance
            # count (:973-974), so the block is groups * batch_max, about the budget
            cap = min(cap, max(1, dn_args.batch_max))
        if cap < targets.num_instances:
            targets = targets.first(cap)  # valid-prefix: a cap is a slice
        N, scalar = targets.num_instances, dn_args.scalar
        if scalar >= 100:
            # a budget of DN queries: the trainer divides it by the batch's
            # largest instance count (compute_dn_groups); else by the cap
            scalar = dn_args.groups if dn_args.groups is not None else max(1, scalar // N)
        B, heads, pad_size = targets.labels.shape[0], self.nheads, scalar * N
        noise_scale, mode = dn_args.noise_scale, self.dn_mode
        valid = targets.valid
        device = valid.device
        gt_masks = targets.masks.float()

        if mode in STATIC3_MODES:
            h8, w8 = size_list[-1]
            fg = resize(gt_masks, (h8, w8), "nearest") > 0.5
            fg = fg[:, None].expand(B, scalar, N, h8, w8).reshape(-1, h8, w8)
            boxes = targets.boxes[:, None].expand(B, scalar, N, 4).reshape(-1, 4).float()
            static3 = [(m.view(B, scalar, N, -1) | ~valid[:, None, :, None])
                       .view(B, 1, pad_size, -1)
                       for m in static3_blocked(mode, fg, boxes, noise_scale, self.dn_ratio,
                                                size_list, generator)]

            def dn_padding_mask(level: int) -> torch.Tensor:
                return static3[level]
        else:
            # a pixel is blocked where no part of the mask falls on it: area
            # downsampling (:986), nearest with < 0.5 in `lb` (:763)
            blocked_lvl = []
            for h, w in size_list:
                if mode == "lb":
                    blk = resize(gt_masks, (h, w), "nearest").reshape(B, N, h * w) < 0.5
                else:
                    blk = resize(gt_masks, (h, w), "area").reshape(B, N, h * w) <= 1e-8
                blocked_lvl.append(blk | ~valid[:, :, None])
            mask_noise = noise_scale if mode in ("points", "mask") else 0.0
            per_head = self.head_dn and mode in ("points", "mask")

            def dn_padding_mask(level: int) -> torch.Tensor:
                """reference gen_mask_dn :1584-1622: each entry flips with a
                probability proportional to the mask's area."""
                blk = blocked_lvl[level]
                s = blk.shape[-1]
                shape = (B, scalar, heads if per_head else 1, N, s)
                m = blk[:, None, None].expand(shape)
                if mask_noise > 0:
                    ratio = (~m).sum(-1).float() * mask_noise / s
                    flip = _uniform_rows(shape, generator, device) < ratio[..., None]
                    m = (m ^ flip) | ~valid[:, None, None, :, None]
                # (B, scalar, heads, N, S) -> (B, heads, scalar * N, S)
                return m.transpose(1, 2).reshape(B, shape[2], pad_size, s)

        labels = targets.labels[:, None, :].expand(B, scalar, N)
        if mode in _REFRESH_MODES and self.dn_label_noise_ratio > 0:
            # class-flip noise (reference :1004-1018; v6-v9 apply the same block)
            flip = _uniform_rows(labels.shape, generator, device) < self.dn_label_noise_ratio
            rand_lb = (_uniform_rows(labels.shape, generator, device) * self.num_classes).long()
            labels = torch.where(flip, rand_lb, labels)
        labels = labels.clamp(0, self.num_classes - 1)
        if mode == "base":
            # the ground truth's mask-averaged float32 pixel features, held
            # fixed (reference :1643-1650 / vanilla :373-380)
            with float32_region(device.type):
                mf = mask_features.float()
                m = resize(gt_masks, mf.shape[-2:], "bilinear")
                feats = torch.einsum("bnhw,bchw->bnc", m, mf) / (m.sum((2, 3))[..., None] + 1e-8)
            content = feats.detach()[:, None].expand(B, scalar, N, feats.shape[-1])
        else:
            content = self.label_enc(labels)
        # multiplicative noise: base and lb (:774-775), shift only without
        # label noise (:1158-1162)
        if noise_scale > 0 and (mode in ("base", "lb") or
                                (mode == "shift" and self.dn_label_noise_ratio <= 0)):
            u = _uniform_rows(content.shape, generator, device)
            content = content + (u * 2 - 1) * noise_scale * content
        content = (content * valid[:, None, :, None]).to(region_dtype(device.type))
        tgt_mask = _dn_tgt_mask(scalar, N, self.num_queries).to(device)
        meta = {"max_num": N, "pad_size": pad_size, "scalar": scalar}
        return content.reshape(B, pad_size, -1), tgt_mask, dn_padding_mask, meta

    def forward(self, x: List[torch.Tensor], mask_features: torch.Tensor,
                dn_args: Optional[DNArgs] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """x: the pixel decoder's [1/32, 1/16, 1/8] maps (B, C, h, w);
        mask_features (B, mask_dim, H/4, W/4). `dn_args` switches the DN
        training path on; its noise is drawn from `generator` (module
        docstring)."""
        if len(x) != self.num_feature_levels:
            raise ValueError(f"expected {self.num_feature_levels} levels, got {len(x)}")
        B, C = x[0].shape[0], self.hidden_dim
        src, pos, size_list = [], [], []
        for i, xi in enumerate(x):
            h, w = xi.shape[-2:]
            size_list.append((h, w))
            pe = position_embedding_sine(h, w, C // 2, device=xi.device, dtype=xi.dtype)
            pos.append(pe.reshape(1, h * w, C))
            src.append(self.input_proj[i](xi).flatten(2).transpose(1, 2)
                       + self.level_embed.weight[i][None, None])

        # the queries enter the layers in the compute type (JAX :469-483)
        output = self.query_feat.weight[None].expand(B, -1, -1).to(region_dtype(x[0].device.type))
        use_dn = dn_args is not None and self.has_label_enc
        tgt_mask, pad_size = None, 0
        if use_dn:
            content, tgt_mask, dn_padding_mask, dn_meta = self._prepare_dn(
                dn_args, size_list, mask_features, generator)
            pad_size = dn_meta["pad_size"]
            output = torch.cat([content, output], dim=1)
        smooth = [None] if self.last_q_ratio > 0 else None

        outputs_class, outputs_mask, attn_mask = self.forward_prediction_heads(
            output, mask_features, size_list[0], smooth)
        if use_dn:
            attn_mask = _with_dn_rows(attn_mask, dn_padding_mask(0))
        predictions_class, predictions_mask = [outputs_class], [outputs_mask]
        for i in range(self.num_layers):
            level_index = i % self.num_feature_levels
            # degenerate all-blocked rows attend everywhere (reference :1780)
            attn_mask = attn_mask & ~attn_mask.all(dim=-1, keepdim=True)
            output = self.transformer_cross_attention_layers[i](
                output, src[level_index], attn_mask, pos[level_index])
            output = self.transformer_self_attention_layers[i](output, tgt_mask)
            output = self.transformer_ffn_layers[i](output)
            level = (i + 1) % self.num_feature_levels
            outputs_class, outputs_mask, attn_mask = self.forward_prediction_heads(
                output, mask_features, size_list[level], smooth)
            # per-layer refresh of the DN rows (reference :1805-1816): in every
            # layer with ALL_LY_DN, else in the first three; elsewhere, and in
            # the modes without a refresh, the DN rows keep the predicted masks
            if use_dn and self.dn_mode in _REFRESH_MODES and (self.all_lys or i < 3):
                attn_mask = _with_dn_rows(attn_mask, dn_padding_mask(level))
            predictions_class.append(outputs_class)
            predictions_mask.append(outputs_mask)

        dn_out = None
        if use_dn:
            dn_cls = [p[:, :pad_size] for p in predictions_class]
            dn_msk = [p[:, :pad_size] for p in predictions_mask]
            predictions_class = [p[:, pad_size:] for p in predictions_class]
            predictions_mask = [p[:, pad_size:] for p in predictions_mask]
            dn_out = {"pred_logits": dn_cls[-1], "pred_masks": dn_msk[-1],
                      "aux_outputs": [{"pred_logits": a, "pred_masks": b}
                                      for a, b in zip(dn_cls[:-1], dn_msk[:-1])],
                      "dn_args": dn_meta}
        out = {
            "pred_logits": predictions_class[-1],
            "pred_masks": predictions_mask[-1],
            "aux_outputs": [{"pred_logits": a, "pred_masks": b}
                            for a, b in zip(predictions_class[:-1], predictions_mask[:-1])],
        }
        if dn_args is not None:
            out["dn_out"] = dn_out
        return out


@TRANSFORMER_DECODER_REGISTRY.register()
class MultiScaleMaskedTransformerDecoder(MultiScaleMaskedTransformerDecoderMaskDN):
    """Vanilla Mask2Former decoder (reference :209-555): no DN label embedding."""

    has_label_enc = False


@TRANSFORMER_DECODER_REGISTRY.register()
class MultiScaleMaskedTransformerDecoderMaskDNLYSmooth(MultiScaleMaskedTransformerDecoderMaskDN):
    """MaskDN with the cross-layer EMA of the mask embeddings (reference
    :1919-3281, the smoothing at :3226-3240, r = MODEL.MASK_FORMER.LAST_Q_RATIO):
    the JAX package's subclass adds nothing to MaskDN, which smooths wherever
    LAST_Q_RATIO > 0 (JAX :571-576)."""
