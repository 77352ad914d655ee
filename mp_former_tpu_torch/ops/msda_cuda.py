"""Multi-scale deformable sampling: the CUDA kernel K1 and its plain version.

`msda_fwd` launches `csrc/msda_fwd.cu` (the port of the TPU kernel
`mp_former_tpu/ops/msda_pallas.py:_gather_weight_level`);
`ms_deform_attn_plain` is the same function in plain PyTorch, the grid_sample
form of the reference's CPU path (`ms_deform_attn_core_pytorch`), and
`ms_deform_attn_folded` is it once more in the kernel's own arithmetic. The
dispatcher `ops/ms_deform_attn.py:ms_deform_attn` sends CUDA tensors to the
kernel and CPU tensors to the plain version.

Layouts (the JAX package's): value (B, S, M, D), sampling_locations
(B, Q, M, L, P, 2) in [0, 1] as (x, y), attention_weights (B, Q, M, L, P);
result (B, Q, M * D).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .cuda_build import DTYPE_CODES, check_inputs, launch

# launches of the kernel since the last reset (a plain counter: a run shows
# that its path went through the kernel)
LAUNCHES = 0


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """grid_sample form (reference ms_deform_attn_func.py:52-72)."""
    B, S, M, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    value_list = value.split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * sampling_locations - 1
    samples = []
    for lid, (h, w) in enumerate(spatial_shapes):
        v = value_list[lid].flatten(2).transpose(1, 2).reshape(B * M, D, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)     # (B*M, Q, P, 2)
        samples.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))        # (B*M, D, Q, P)
    attn = attention_weights.transpose(1, 2).reshape(B * M, 1, Q, L * P)
    out = (torch.stack(samples, dim=-2).flatten(-2) * attn).sum(-1).view(B, M * D, Q)
    return out.transpose(1, 2).contiguous()


def _level_starts(shapes: Sequence[Tuple[int, int]]):
    starts = [0]
    for h, w in shapes[:-1]:
        starts.append(starts[-1] + h * w)
    return starts


def ms_deform_attn_folded(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor) -> torch.Tensor:
    """The same function in the kernel's arithmetic: per point the pixel
    corner, four tap indices clamped onto the map and four tap weights =
    bilinear x validity x attention (0 for a tap off the map, and for a point
    whose location is not finite or lies a pixel or more off the map), then a
    gather of the taps and one sum over levels, points and taps."""
    B, S, M, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    hw = torch.tensor(spatial_shapes, dtype=torch.float32, device=value.device)
    H, W = hw[:, 0].view(L, 1), hw[:, 1].view(L, 1)
    start = torch.tensor(_level_starts(spatial_shapes), device=value.device).view(L, 1)
    loc = sampling_locations.float()
    x, y = loc[..., 0] * W - 0.5, loc[..., 1] * H - 0.5             # (B, Q, M, L, P)
    x0, y0 = x.floor(), y.floor()
    valid = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    zero = torch.zeros((), device=value.device)
    tx, ty = torch.where(valid, x - x0, zero), torch.where(valid, y - y0, zero)
    a = torch.where(valid, attention_weights.float(), zero)
    x0, y0 = torch.where(valid, x0, zero), torch.where(valid, y0, zero)
    wx = torch.stack([torch.where(x0 >= 0, 1 - tx, zero), torch.where(x0 + 1 < W, tx, zero)], -1)
    wy = torch.stack([torch.where(y0 >= 0, a * (1 - ty), zero),
                      torch.where(y0 + 1 < H, a * ty, zero)], -1)
    xi = torch.stack([x0.clamp(min=0), torch.minimum(x0 + 1, W - 1)], -1).long()
    yi = torch.stack([y0.clamp(min=0), torch.minimum(y0 + 1, H - 1)], -1).long()
    # taps in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1): (B, Q, M, L, P, 2, 2)
    idx = start[..., None, None] + yi[..., :, None] * W.long()[..., None, None] + xi[..., None, :]
    w = wy[..., :, None] * wx[..., None, :]
    idx = idx.permute(0, 2, 1, 3, 4, 5, 6).reshape(B, M, Q * L * P * 4, 1)
    taps = torch.gather(value.float().permute(0, 2, 1, 3), 2, idx.expand(-1, -1, -1, D))
    w = w.permute(0, 2, 1, 3, 4, 5, 6).reshape(B, M, Q, L * P * 4, 1)
    out = (taps.view(B, M, Q, L * P * 4, D) * w).sum(3)             # (B, M, Q, D)
    return out.transpose(1, 2).reshape(B, Q, M * D).to(value.dtype)


@functools.lru_cache(maxsize=64)
def _level_table(shapes: Tuple[Tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    """(L, 3) int32 on `device`: H, W and first token of each level. Cached per
    canvas: a copy from the host would wait for the stream at every layer."""
    rows = [(h, w, s) for (h, w), s in zip(shapes, _level_starts(shapes))]
    return torch.tensor(rows, dtype=torch.int32).to(device)


def msda_fwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors (forward only); raises on anything it does
    not take, and if the launch fails."""
    global LAUNCHES
    device = check_inputs("msda_fwd", (value, sampling_locations, attention_weights),
                          tuple(DTYPE_CODES), align=16)
    B, S, M, D = value.shape
    if D != 32:
        raise ValueError(f"msda_fwd: the kernel takes 32 channels per head, got {D}")
    Q, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    if sampling_locations.shape != (B, Q, M, L, P, 2):
        raise ValueError(f"msda_fwd: sampling_locations {tuple(sampling_locations.shape)} "
                         f"is not (B, Q, M, L, P, 2) for value {tuple(value.shape)}")
    if attention_weights.shape != (B, Q, M, L, P):
        raise ValueError(f"msda_fwd: attention_weights {tuple(attention_weights.shape)} "
                         f"is not {(B, Q, M, L, P)}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if len(shapes) != L or sum(h * w for h, w in shapes) != S:
        raise ValueError(f"msda_fwd: spatial_shapes {list(spatial_shapes)} do not tile "
                         f"S={S} in L={L} levels")
    if S * M * D >= 2 ** 31 or B * Q * M >= 2 ** 31:
        raise ValueError(f"msda_fwd: the kernel indexes one batch element's values and the "
                         f"(batch, query, head) pairs in 32 bits; S*M*D={S * M * D} or "
                         f"B*Q*M={B * Q * M} is too large")
    out = torch.empty((B, Q, M * D), dtype=value.dtype, device=device)
    launch("msda_fwd", device, value.data_ptr(), _level_table(shapes, device).data_ptr(),
           sampling_locations.data_ptr(), attention_weights.data_ptr(), out.data_ptr(),
           B, S, Q, M, L, P, D, DTYPE_CODES[value.dtype])
    LAUNCHES += 1
    return out
