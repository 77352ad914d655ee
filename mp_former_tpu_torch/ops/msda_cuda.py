"""Multi-scale deformable sampling: the CUDA kernel K1 and its plain version.

`msda_fwd` launches `csrc/msda_fwd.cu` (the port of the TPU kernel
`mp_former_tpu/ops/msda_pallas.py:_gather_weight_level`);
`ms_deform_attn_plain` is the same function in plain PyTorch, the reference's
CPU path (`ms_deform_attn_core_pytorch`) as four gathers a level, and
`ms_deform_attn_folded` is it once more in the kernel's own order of sums.
`msda_bwd` launches `csrc/msda_bwd.cu`, the three gradients in one kernel (the
JAX package's VJP, `msda_pallas.py:249-258`, recomputes through XLA instead);
`ms_deform_attn_backward_plain` is the same three formulas on tensors, without
autograd, for the tests and `chip_smoke.py`. `MSDeformAttnFunction` joins the
two kernels for autograd. The dispatcher `ops/ms_deform_attn.py:ms_deform_attn`
sends CUDA tensors to the kernels and CPU tensors to the plain version.

Layouts (the JAX package's): value (B, S, M, D), sampling_locations
(B, Q, M, L, P, 2) in [0, 1] as (x, y), attention_weights (B, Q, M, L, P);
result (B, Q, M * D). Types the kernels take: all float32, all bfloat16, or
value (and grad_out) bfloat16 with float32 locations and weights, the model's
bfloat16 mode, whose sampling arithmetic is float32 as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .cuda_build import DTYPE_CODES, check_inputs, launch

# launches of the forward and of the backward kernel since the last reset
# (plain counters: a run shows that its path went through the kernels)
LAUNCHES = 0
BWD_LAUNCHES = 0
# the channels a head the two kernels take (`csrc/msda_fwd.cu`, `msda_bwd.cu`: kD)
CHANNELS = 32


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


def _level_starts(shapes: Sequence[Tuple[int, int]]):
    starts = [0]
    for h, w in shapes[:-1]:
        starts.append(starts[-1] + h * w)
    return starts


@functools.lru_cache(maxsize=64)
def _level_table(shapes: Tuple[Tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    """(L, 3) int32 on `device`: H, W and first token of each level. Cached per
    canvas: a copy from the host would wait for the stream at every layer."""
    rows = [(h, w, s) for (h, w), s in zip(shapes, _level_starts(shapes))]
    return torch.tensor(rows, dtype=torch.int32).to(device)


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 as in the kernels, or float64 where a test hands that in."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _tap_geometry(spatial_shapes: Sequence[Tuple[int, int]], sampling_locations: torch.Tensor):
    """The kernels' view of the sampling points. Per point (B, Q, M, L, P): the
    token index of its four taps clamped onto the map, (..., 2, 2) in the order
    (y0, x0), (y0, x1), (y1, x0), (y1, x1); the bilinear factors of its two
    columns and two rows, (..., 2) each, 0 for a column or row off the map;
    their derivatives in x and y (in pixels: -1, +1 or 0); whether the point
    counts at all (its location is finite and less than a pixel off the map;
    the factors of a point that does not count are arbitrary); and the levels'
    (W, H) as (L, 1) floats."""
    L = len(spatial_shapes)
    device = sampling_locations.device
    dtype = _work_dtype(sampling_locations)
    # cached on the device: a copy from the host would not fit a CUDA graph
    table = _level_table(tuple((int(h), int(w)) for h, w in spatial_shapes), device)
    H, W = table[:, 0].to(dtype).view(L, 1), table[:, 1].to(dtype).view(L, 1)
    start = table[:, 2].long().view(L, 1)
    loc = sampling_locations.to(dtype)
    x, y = loc[..., 0] * W - 0.5, loc[..., 1] * H - 0.5             # (B, Q, M, L, P)
    x0, y0 = x.floor(), y.floor()
    valid = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    zero, one = torch.zeros((), dtype=dtype, device=device), torch.ones((), dtype=dtype, device=device)
    tx, ty = torch.where(valid, x - x0, zero), torch.where(valid, y - y0, zero)
    x0, y0 = torch.where(valid, x0, zero), torch.where(valid, y0, zero)
    bx = torch.stack([torch.where(x0 >= 0, 1 - tx, zero), torch.where(x0 + 1 < W, tx, zero)], -1)
    by = torch.stack([torch.where(y0 >= 0, 1 - ty, zero), torch.where(y0 + 1 < H, ty, zero)], -1)
    sx = torch.stack([torch.where(x0 >= 0, -one, zero), torch.where(x0 + 1 < W, one, zero)], -1)
    sy = torch.stack([torch.where(y0 >= 0, -one, zero), torch.where(y0 + 1 < H, one, zero)], -1)
    xi = torch.stack([x0.clamp(min=0), torch.minimum(x0 + 1, W - 1)], -1).long()
    yi = torch.stack([y0.clamp(min=0), torch.minimum(y0 + 1, H - 1)], -1).long()
    idx = start[..., None, None] + yi[..., :, None] * W.long()[..., None, None] + xi[..., None, :]
    return idx, bx, by, sx, sy, valid, W, H


def _gather_taps(value: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """value (B, S, M, D), idx (B, Q, M, L, P, 2, 2) -> taps (B, M, Q, L*P*4, D)."""
    B, S, M, D = value.shape
    Q = idx.shape[1]
    flat = idx.permute(0, 2, 1, 3, 4, 5, 6).reshape(B, M, -1, 1)
    taps = torch.gather(value.to(_work_dtype(value)).permute(0, 2, 1, 3), 2,
                        flat.expand(-1, -1, -1, D))
    return taps.view(B, M, Q, -1, D)


def ms_deform_attn_folded(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor) -> torch.Tensor:
    """The same function in the kernel's arithmetic: per point the pixel
    corner, four tap indices clamped onto the map and four tap weights =
    bilinear x validity x attention (0 for a tap off the map, and for a point
    whose location is not finite or lies a pixel or more off the map), then a
    gather of the taps and one sum over levels, points and taps."""
    B, S, M, D = value.shape
    Q = sampling_locations.shape[1]
    idx, bx, by, _, _, valid, _, _ = _tap_geometry(spatial_shapes, sampling_locations)
    a = attention_weights.to(bx.dtype) * valid
    w = (a[..., None] * by)[..., :, None] * bx[..., None, :]         # (B, Q, M, L, P, 2, 2)
    taps = _gather_taps(value, idx)
    w = w.permute(0, 2, 1, 3, 4, 5, 6).reshape(B, M, Q, -1, 1)
    out = (taps * w).sum(3)                                         # (B, M, Q, D)
    return out.transpose(1, 2).reshape(B, Q, M * D).to(value.dtype)


def ms_deform_attn_backward_plain(grad_out: torch.Tensor, value: torch.Tensor,
                                  spatial_shapes: Sequence[Tuple[int, int]],
                                  sampling_locations: torch.Tensor,
                                  attention_weights: torch.Tensor):
    """The gradients of `ms_deform_attn_plain` with respect to value, sampling
    locations and attention weights, written out on tensors (no autograd), in
    the backward kernel's arithmetic. With g = grad_out[b, q, m], the taps t
    of a point, their bilinear weights b_t (0 off the map) and d_t = <value[tap
    t], g>: grad_value[tap t] += a b_t g, grad_attn = sum_t b_t d_t, grad_loc =
    a (W sum_t db_t/dx d_t, H sum_t db_t/dy d_t). floor() passes no gradient; a
    point that does not count (not finite, or a pixel or more off the map)
    contributes nothing. Returns float32 tensors in the inputs' shapes (float64
    for float64 inputs)."""
    B, S, M, D = value.shape
    Q = sampling_locations.shape[1]
    idx, bx, by, sx, sy, valid, W, H = _tap_geometry(spatial_shapes, sampling_locations)
    a = attention_weights.to(bx.dtype) * valid
    g = grad_out.to(bx.dtype).view(B, Q, M, D).permute(0, 2, 1, 3)   # (B, M, Q, D)
    taps = _gather_taps(value, idx)                                  # (B, M, Q, K, D)
    d = (taps * g[:, :, :, None, :]).sum(-1)                         # (B, M, Q, K)
    del taps
    d = d.view(B, M, Q, *idx.shape[3:]).permute(0, 2, 1, 3, 4, 5, 6)  # (B, Q, M, L, P, 2, 2)
    rows = (d * bx[..., None, :]).sum(-1)                            # per tap row: sum over x
    grad_attn = (by * rows).sum(-1) * valid
    grad_x = a * W * (by * (d * sx[..., None, :]).sum(-1)).sum(-1)
    grad_y = a * H * (sy * rows).sum(-1)
    grad_loc = torch.stack([grad_x, grad_y], -1)
    w = (a[..., None] * by)[..., :, None] * bx[..., None, :]         # (B, Q, M, L, P, 2, 2)
    w = w.permute(0, 2, 1, 3, 4, 5, 6).reshape(B, M, Q, -1, 1)
    flat = idx.permute(0, 2, 1, 3, 4, 5, 6).reshape(B, M, -1, 1)
    grad_value = torch.zeros((B, M, S, D), dtype=bx.dtype, device=value.device)
    grad_value.scatter_add_(2, flat.expand(-1, -1, -1, D),
                            (w * g[:, :, :, None, :]).reshape(B, M, -1, D))
    return grad_value.permute(0, 2, 1, 3).contiguous(), grad_loc, grad_attn


def _check_shapes(name: str, value, spatial_shapes, sampling_locations, attention_weights):
    """The shape rules both kernels share; returns (B, S, Q, M, L, P, D) and
    the level sizes as a tuple."""
    B, S, M, D = value.shape
    if D != CHANNELS:
        raise ValueError(f"{name}: the kernel takes {CHANNELS} channels per head, got {D}")
    Q, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    if sampling_locations.shape != (B, Q, M, L, P, 2):
        raise ValueError(f"{name}: sampling_locations {tuple(sampling_locations.shape)} "
                         f"is not (B, Q, M, L, P, 2) for value {tuple(value.shape)}")
    if attention_weights.shape != (B, Q, M, L, P):
        raise ValueError(f"{name}: attention_weights {tuple(attention_weights.shape)} "
                         f"is not {(B, Q, M, L, P)}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if len(shapes) != L or sum(h * w for h, w in shapes) != S:
        raise ValueError(f"{name}: spatial_shapes {list(spatial_shapes)} do not tile "
                         f"S={S} in L={L} levels")
    # the batch element's base is 64-bit, so B does not enter the first limit
    if S * M * D >= 2 ** 31 or B * Q * M >= 2 ** 31:
        raise ValueError(f"{name}: the kernel indexes one batch element's values and the "
                         f"(batch, query, head) pairs in 32 bits; S*M*D={S * M * D} or "
                         f"B*Q*M={B * Q * M} is too large")
    return (B, S, Q, M, L, P, D), shapes


def _check_types(name: str, value, sampling_locations, attention_weights, *more):
    """value (and `more`) float32 or bfloat16, the locations and weights of
    one type, value's or float32; returns the device and the kernels' type
    code: 0 float32, 1 bfloat16, 2 bfloat16 value with float32 locations and
    weights."""
    device = check_inputs(name, (value, *more), tuple(DTYPE_CODES), align=16)
    sampling = tuple(dict.fromkeys((value.dtype, torch.float32)))
    if check_inputs(name, (sampling_locations, attention_weights), sampling, align=16) != device:
        raise ValueError(f"{name}: all inputs must be CUDA tensors on one device")
    return device, 2 if sampling_locations.dtype != value.dtype else DTYPE_CODES[value.dtype]


def msda_fwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors (forward only); raises on anything it does
    not take, and if the launch fails."""
    global LAUNCHES
    device, code = _check_types("msda_fwd", value, sampling_locations, attention_weights)
    (B, S, Q, M, L, P, D), shapes = _check_shapes("msda_fwd", value, spatial_shapes,
                                                  sampling_locations, attention_weights)
    out = torch.empty((B, Q, M * D), dtype=value.dtype, device=device)
    launch("msda_fwd", device, value.data_ptr(), _level_table(shapes, device).data_ptr(),
           sampling_locations.data_ptr(), attention_weights.data_ptr(), out.data_ptr(),
           B, S, Q, M, L, P, D, code)
    LAUNCHES += 1
    return out


def msda_bwd(grad_out: torch.Tensor, value: torch.Tensor,
             spatial_shapes: Sequence[Tuple[int, int]], sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor):
    """Launch K1's backward on CUDA tensors: (grad_value, grad_sampling_locations,
    grad_attention_weights) in the inputs' shapes and type. grad_value is summed
    with float32 atomics (and cast for bfloat16 inputs), so its last bits vary
    from run to run. Raises on anything the kernel does not take, and if the
    launch fails."""
    global BWD_LAUNCHES
    device, code = _check_types("msda_bwd", value, sampling_locations, attention_weights,
                                grad_out)
    (B, S, Q, M, L, P, D), shapes = _check_shapes("msda_bwd", value, spatial_shapes,
                                                  sampling_locations, attention_weights)
    if grad_out.shape != (B, Q, M * D):
        raise ValueError(f"msda_bwd: grad_out {tuple(grad_out.shape)} is not {(B, Q, M * D)}")
    grad_value = torch.zeros((B, S, M, D), dtype=torch.float32, device=device)
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    launch("msda_bwd", device, grad_out.data_ptr(), value.data_ptr(),
           _level_table(shapes, device).data_ptr(), sampling_locations.data_ptr(),
           attention_weights.data_ptr(), grad_value.data_ptr(), grad_loc.data_ptr(),
           grad_attn.data_ptr(), B, S, Q, M, L, P, D, code)
    BWD_LAUNCHES += 1
    return grad_value.to(value.dtype), grad_loc, grad_attn


class MSDeformAttnFunction(torch.autograd.Function):
    """K1 with its gradient: `msda_fwd` forward, `msda_bwd` backward, on CUDA
    tensors. apply(value, spatial_shapes, sampling_locations, attention_weights)."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        tensors = tuple(t.detach().contiguous()
                        for t in (value, sampling_locations, attention_weights))
        ctx.save_for_backward(*tensors)
        ctx.spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        return msda_fwd(tensors[0], ctx.spatial_shapes, tensors[1], tensors[2])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        grad_value, grad_loc, grad_attn = msda_bwd(grad_out.contiguous(), value,
                                                   ctx.spatial_shapes, loc, attn)
        return grad_value, None, grad_loc, grad_attn
