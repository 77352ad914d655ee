"""Multi-scale deformable attention (`mp_former_tpu/ops/ms_deform_attn.py`).

`ms_deform_attn` is the core with per-head sampling locations: CUDA tensors go
to the hand-written kernel K1 (`ops/msda_cuda.py:msda_fwd`, and through
`MSDeformAttnFunction` with its backward kernel where a gradient is asked for),
CPU tensors to its plain version. With `pallas_weighting=True` it takes the JAX package's split
form instead: a 2x2 patch table, one gathered row per (head, point, query) and
the tap-weighting kernel K2 (`ops/tap_weighting.py:weight_taps`), batched over
the B*M head tables. The two routes compute the same function; K1 takes heads
of 32 channels, so CUDA values with other head widths take the second.

`ms_deform_attn_headshare` is the head-shared engine (`TPU.SAMPLING_ENGINE
headshare`): all heads sample at the same locations, so one gathered row
carries the taps of every head, and K2 weights them per head.

Both K2 routes train: where a gradient is asked for, K2 runs through
`TapWeightingFunction` (its backward kernel), the gather's gradient is
`index_select`'s own scatter-add (the JAX package's gather is XLA's too), and
the bilinear tap weights are differentiable in the locations, as JAX's are.

`MSDeformAttn` is the module of reference ops/modules/ms_deform_attn.py:34-125
with its state-dict names (sampling_offsets, attention_weights, value_proj,
output_proj) and its initialisation, including the compass-rose bias of the
sampling offsets (per head, or per point for the head-shared engine).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import flops
from .msda_cuda import CHANNELS as K1_CHANNELS, MSDeformAttnFunction, ms_deform_attn_plain, msda_fwd
from .tap_weighting import weight_taps

SAMPLING_ENGINES = ("packed2x2", "pallas", "headshare")


def _patch_table(v: torch.Tensor) -> torch.Tensor:
    """v (G, H, W, C) -> (G * (H+1) * (W+1), 4 * C): row y * (W+1) + x of table
    g holds the 2x2 taps whose top-left pixel is (y-1, x-1) on the zero-padded
    map, lanes (tap, channel) major to minor, taps in the order (y, x), (y,
    x+1), (y+1, x), (y+1, x+1)."""
    G, H, W, C = v.shape
    vpad = F.pad(v, (0, 0, 1, 1, 1, 1))
    patch = torch.cat([vpad[:, :-1, :-1], vpad[:, :-1, 1:], vpad[:, 1:, :-1], vpad[:, 1:, 1:]],
                      dim=-1)
    return patch.reshape(G * (H + 1) * (W + 1), 4 * C)


def _patch_rows_and_weights(loc: torch.Tensor, H: int, W: int):
    """loc (..., 2) in [0, 1] as (x, y) -> (row index (...) int64 into one
    level's patch table, bilinear tap weights (..., 4) float32). A point whose
    patch base had to be clipped has all its taps off the map: its weights
    are zero (grid_sample's zero padding, align_corners=False)."""
    fx = loc[..., 0].float() * W - 0.5
    fy = loc[..., 1].float() * H - 0.5
    x0, y0 = fx.floor(), fy.floor()
    tx, ty = fx - x0, fy - y0
    bx = (x0 + 1).clamp(0, W).long()
    by = (y0 + 1).clamp(0, H).long()
    pvalid = ((x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)).float()
    tw = torch.stack([(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], -1)
    return by * (W + 1) + bx, tw * pvalid[..., None]


def _ms_deform_attn_tap_weighting(value: torch.Tensor,
                                  spatial_shapes: Sequence[Tuple[int, int]],
                                  sampling_locations: torch.Tensor,
                                  attention_weights: torch.Tensor) -> torch.Tensor:
    """The patch-table route of `ms_deform_attn` (JAX :62-132): per level, one
    point-major gather of 4*D-wide rows per (b, m) table and one `weight_taps`
    call with n_heads=1, batched over the B*M tables."""
    B, S, M, D = value.shape
    Q, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    out = torch.zeros((B, Q, M, D), dtype=value.dtype, device=value.device)
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W].transpose(1, 2).reshape(B * M, H, W, D)
        start += H * W
        table = _patch_table(v)                                       # (BM * R, 4D)
        loc = sampling_locations[:, :, :, lid].permute(0, 2, 3, 1, 4)  # (B, M, P, Q, 2)
        w = attention_weights[:, :, :, lid].permute(0, 2, 3, 1)       # (B, M, P, Q)
        idx, tw = _patch_rows_and_weights(loc, H, W)                  # (B, M, P, Q[, 4])
        tw = tw * w[..., None].float()
        R = (H + 1) * (W + 1)
        first_row = torch.arange(B * M, device=value.device).view(B, M, 1, 1) * R
        taps = table.index_select(0, (idx + first_row).reshape(-1))
        del table
        sampled = weight_taps(taps.view(B * M, P * Q, 4 * D),
                              tw.reshape(B * M, P * Q, 4).to(taps.dtype).contiguous(),
                              P, 1, D)                                # (BM, Q, D)
        del taps
        out += sampled.view(B, M, Q, D).transpose(1, 2)
    return out.reshape(B, Q, M * D)


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                   pallas_weighting: bool = False) -> torch.Tensor:
    """value (B, S, M, D), sampling_locations (B, Q, M, L, P, 2) in [0, 1] as
    (x, y), attention_weights (B, Q, M, L, P) -> (B, Q, M * D).
    `pallas_weighting` (TPU.PALLAS_TAP_WEIGHTING) takes the patch-table gather
    and K2 instead of K1; so does a CUDA value whose heads are not K1's 32
    channels wide (the frozen synthetic recipe's 128 channels in 8 heads),
    since that route computes the same function at any width. The JAX
    package's types (`ms_deform_attn.py:56`): value in the compute type, the
    result in value's type, the sampling arithmetic in float32, so locations
    and weights arrive in (or are cast to) float32 when value is bfloat16."""
    if len(spatial_shapes) != sampling_locations.shape[3]:
        raise ValueError(f"ms_deform_attn: {len(spatial_shapes)} spatial shapes for "
                         f"L={sampling_locations.shape[3]} levels")
    work = torch.promote_types(value.dtype, torch.float32)
    sampling_locations = sampling_locations.to(work)
    attention_weights = attention_weights.to(work)
    if pallas_weighting or (value.is_cuda and value.shape[-1] != K1_CHANNELS):
        return _ms_deform_attn_tap_weighting(value, spatial_shapes, sampling_locations,
                                             attention_weights)
    if value.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (value, sampling_locations, attention_weights)):
            return MSDeformAttnFunction.apply(value, spatial_shapes, sampling_locations,
                                              attention_weights)
        return msda_fwd(value, spatial_shapes, sampling_locations, attention_weights)
    if flops.counting():
        points, d = flops.k1_points(sampling_locations), value.shape[-1]
        return flops.plain_counted(
            lambda *t: ms_deform_attn_plain(t[0], spatial_shapes, *t[1:]), "K1",
            flops.k1_flops(points, d), flops.k1_backward_flops(points, d),
            value, sampling_locations, attention_weights)
    return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)


def ms_deform_attn_headshare(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor,
                             pallas_weighting: bool = False) -> torch.Tensor:
    """Head-shared deformable sampling (JAX `ms_deform_attn_headshare`): all
    heads sample at the same locations, attention weights stay per head. A
    deviation from the reference that a model must be trained with.

    value (B, S, M, D), sampling_locations (B, Q, L, P, 2) in [0, 1] as (x, y),
    attention_weights (B, Q, M, L, P) -> (B, Q, M * D).

    Per level: a 2x2 patch table with 4*M*D-wide rows, one gathered row per
    (point, query), and one `weight_taps` call (point-major rows, K2 on CUDA
    tensors). CUDA tensors always go through K2. `pallas_weighting=False` on
    CPU tensors takes the JAX package's query-major multiply-and-sum form
    instead, which is this function's plain route. Each level's taps are freed
    before the next level's are gathered."""
    B, S, M, D = value.shape
    _, Q, L, P, _ = sampling_locations.shape
    if len(spatial_shapes) != L:
        raise ValueError(f"ms_deform_attn_headshare: {len(spatial_shapes)} spatial shapes "
                         f"for L={L} levels")
    out = torch.zeros((B, Q, M * D), dtype=value.dtype, device=value.device)
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        table = _patch_table(value[:, start:start + H * W].reshape(B, H, W, M * D))
        start += H * W
        idx, tw = _patch_rows_and_weights(sampling_locations[:, :, lid], H, W)  # (B, Q, P[, 4])
        w = attention_weights[:, :, :, lid].float()                   # (B, Q, M, P)
        full = tw[..., None] * w.transpose(2, 3)[..., None, :]        # (B, Q, P, 4, M)
        R = (H + 1) * (W + 1)
        idx = idx + torch.arange(B, device=value.device).view(B, 1, 1) * R
        if value.is_cuda or pallas_weighting:
            taps = table.index_select(0, idx.transpose(1, 2).reshape(-1))
            del table
            w_pm = full.transpose(1, 2).reshape(B, P * Q, 4 * M).to(taps.dtype)
            out += weight_taps(taps.view(B, P * Q, 4 * M * D), w_pm.contiguous(), P, M, D)
        else:
            taps = table.index_select(0, idx.reshape(-1)).view(B, Q, P, 4, M, D)
            del table

            def weighted(taps, full):
                wtaps = taps * full.to(taps.dtype)[..., None]
                return wtaps.sum(dim=3).sum(dim=2).reshape(B, Q, M * D)

            if flops.counting():  # the function K2 computes on CUDA tensors
                out += flops.plain_counted(weighted, "K2", flops.k2_flops(taps.numel()),
                                           flops.k2_backward_flops(taps.numel()), taps, full)
            else:
                out += weighted(taps, full)
        del taps
    return out


class MSDeformAttn(nn.Module):
    """Deformable-attention module.

    sampling_engine (TPU.SAMPLING_ENGINE): 'packed2x2' and 'pallas' are the
    reference's per-head sampling locations (reference checkpoints load
    unchanged; on CUDA tensors K1, or the patch-table gather and K2 when
    `pallas_weighting` is set); 'headshare' is one location set shared by all
    heads, so `sampling_offsets` has L*P*2 outputs and checkpoints of the two
    kinds do not interconvert. On CUDA tensors the head-shared engine always
    goes through K2, whatever `pallas_weighting` (TPU.PALLAS_TAP_WEIGHTING)
    says: the flag only chooses between the two plain formulations on the CPU.
    With 'pallas' the per-head engine is always K1, as in the JAX package
    where its kernel takes the shapes."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, sampling_engine: str = "packed2x2",
                 pallas_weighting: bool = False):
        super().__init__()
        if d_model % n_heads != 0:
            raise ValueError(f"d_model {d_model} is not divisible by n_heads {n_heads}")
        if sampling_engine not in SAMPLING_ENGINES:
            raise ValueError(f"sampling_engine {sampling_engine!r} is not one of "
                             f"{SAMPLING_ENGINES}")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.headshare = sampling_engine == "headshare"
        self.pallas_weighting = bool(pallas_weighting) and sampling_engine != "pallas"
        self.sampling_offsets = nn.Linear(
            d_model, (1 if self.headshare else n_heads) * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self._reset_parameters()

    def _offset_bias(self) -> torch.Tensor:
        """Unit vectors on a compass rose, scaled by point index: one
        direction per head (reference _reset_parameters :66-80, JAX
        `_offset_bias_init`), or per point for the head-shared engine (JAX
        `_offset_bias_init_shared`)."""
        n = self.n_points if self.headshare else self.n_heads
        thetas = torch.arange(n, dtype=torch.float64) * (2.0 * math.pi / n)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True)[0]
        if self.headshare:
            grid = grid.view(1, self.n_points, 2).repeat(self.n_levels, 1, 1)
        else:
            grid = grid.view(self.n_heads, 1, 1, 2).repeat(1, self.n_levels, self.n_points, 1)
        for i in range(self.n_points):
            grid[..., i, :] *= i + 1
        return grid.reshape(-1).float()

    def _reset_parameters(self) -> None:
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(self._offset_bias())
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        nn.init.xavier_uniform_(self.value_proj.weight)
        nn.init.zeros_(self.value_proj.bias)
        nn.init.xavier_uniform_(self.output_proj.weight)
        nn.init.zeros_(self.output_proj.bias)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (B, Q, C); reference_points (B, Q, L, 2) in [0, 1] or
        (B, Q, L, 4) boxes; input_flatten (B, S, C), unpadded; spatial_shapes
        [(H, W)] per level."""
        B, Q, _ = query.shape
        S = input_flatten.shape[1]
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten).view(B, S, M, self.d_model // M)
        # (B, Q, 1, L, P, 2) for the head-shared engine: the head axis broadcasts
        offsets = self.sampling_offsets(query).view(B, Q, -1, L, P, 2)
        attn = self.attention_weights(query).view(B, Q, M, L * P).softmax(-1)
        attn = attn.view(B, Q, M, L, P)
        if reference_points.shape[-1] == 2:
            # offsets are in pixels of each level: normalise by (W, H), x first
            # (a non-blocking copy: a blocking one waits for the stream)
            normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=offsets.dtype)
            normalizer = normalizer.to(offsets.device, non_blocking=True)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / normalizer[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 4:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P * reference_points[:, :, None, :, None, 2:] * 0.5)
        else:
            raise ValueError("reference_points last dim must be 2 or 4")
        if self.headshare:
            out = ms_deform_attn_headshare(value, spatial_shapes, loc[:, :, 0].contiguous(),
                                           attn, pallas_weighting=self.pallas_weighting)
        else:
            out = ms_deform_attn(value.contiguous(), spatial_shapes, loc.contiguous(),
                                 attn.contiguous(), pallas_weighting=self.pallas_weighting)
        return self.output_proj(out)
