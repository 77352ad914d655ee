"""Multi-scale deformable attention in plain PyTorch: a frozen copy of the
port's plain version of K1 (`ms_deform_attn_plain`) and of its module,
without the kernels and with the per-head sampling engine alone. Autograd of
the plain ops gives the backward. `count.k1` sees every call, so the
benchmark's FLOP and byte count reads the same work as the port's kernel
does."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ... import flops as count
from .chunks import per_image

SAMPLING_ENGINES = ("packed2x2", "pallas")


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 as in the kernels, or float64 where a test hands that in."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32



def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding (the reference's CPU path,
    ms_deform_attn_func.py:52-72, grid_sample with align_corners=False) as
    four gathers a level, autograd of plain ops. The pixel coordinate is
    rounded as the JAX package (`ms_deform_attn.py:88`) and the kernels round
    it, loc * W, then - 0.5: grid_sample's ((2 loc - 1 + 1) W - 1) / 2 floors
    some pixel centres to the other side, where the derivative in the
    location jumps (every location of the reference init, on a level whose
    size is no power of two). A point whose location is not finite adds
    nothing. Sampling arithmetic in float32 (float64 for float64 locations),
    the result in value's type."""
    dtype = value.dtype
    work = _work_dtype(sampling_locations)
    B, S, M, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    values = value.to(work).permute(0, 2, 1, 3).split([h * w for h, w in spatial_shapes], dim=2)
    locs = sampling_locations.to(work).permute(0, 2, 3, 1, 4, 5)      # (B, M, L, Q, P, 2)
    attn = attention_weights.to(work).permute(0, 2, 3, 1, 4)          # (B, M, L, Q, P)
    out = torch.zeros((B * M, Q, D), dtype=work, device=value.device)
    for lid, (h, w) in enumerate(spatial_shapes):
        v = values[lid].reshape(B * M, h * w, D)
        x = locs[:, :, lid, ..., 0] * w - 0.5
        y = locs[:, :, lid, ..., 1] * h - 0.5
        finite = torch.isfinite(x) & torch.isfinite(y)
        x, y = torch.where(finite, x, -2.0), torch.where(finite, y, -2.0)  # no tap on the map
        x0, y0 = x.floor(), y.floor()
        tx, ty = x - x0, y - y0
        for yi, wy in ((y0, 1 - ty), (y0 + 1, ty)):
            for xi, wx in ((x0, 1 - tx), (x0 + 1, tx)):
                on = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
                taps = v.gather(1, idx.reshape(B * M, Q * P, 1).expand(-1, -1, D))
                weight = (wx * wy * attn[:, :, lid] * on).reshape(B * M, Q * P, 1)
                out = out + (taps * weight).view(B * M, Q, P, D).sum(2)
    return out.view(B, M, Q, D).transpose(1, 2).reshape(B, Q, M * D).to(dtype)


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                   pallas_weighting: bool = False) -> torch.Tensor:
    """value (B, S, M, D), sampling_locations (B, Q, M, L, P, 2) in [0, 1] as
    (x, y), attention_weights (B, Q, M, L, P) -> (B, Q, M * D), in plain ops."""
    if pallas_weighting:
        raise NotImplementedError("the reference has no tap-weighting route")
    work = torch.promote_types(value.dtype, torch.float32)
    sampling_locations = sampling_locations.to(work)
    attention_weights = attention_weights.to(work)
    return count.k1(per_image(ms_deform_attn_plain, 1), value, spatial_shapes,
                    sampling_locations, attention_weights)


class MSDeformAttn(nn.Module):
    """Deformable-attention module with per-head sampling locations (the
    reference's, and the port's `packed2x2` and `pallas` engines), through
    the plain K1. The head-shared engine and the tap-weighting route are not
    in the reference."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, sampling_engine: str = "packed2x2",
                 pallas_weighting: bool = False):
        super().__init__()
        if d_model % n_heads != 0:
            raise ValueError(f"d_model {d_model} is not divisible by n_heads {n_heads}")
        if sampling_engine not in SAMPLING_ENGINES or pallas_weighting:
            raise ValueError(f"the reference samples per head only (sampling_engine "
                             f"{SAMPLING_ENGINES}, no tap weighting), not {sampling_engine!r}")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.pallas_weighting = False
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self._reset_parameters()

    def _offset_bias(self) -> torch.Tensor:
        """Unit vectors on a compass rose, one direction per head, scaled by
        point index (reference _reset_parameters :66-80)."""
        thetas = torch.arange(self.n_heads, dtype=torch.float64) * (2.0 * math.pi / self.n_heads)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True)[0]
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
        out = ms_deform_attn(value.contiguous(), spatial_shapes, loc.contiguous(),
                             attn.contiguous(), pallas_weighting=self.pallas_weighting)
        return self.output_proj(out)
