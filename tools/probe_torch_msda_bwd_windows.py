"""The window-stationary design of K1 backward on tensors: the block map,
window rule, split of the taps inside and outside the windows, and flush of
`tools/probe_torch_msda_bwd_windows.cu` (a redesign measured on the card and
not taken; PERF.md), repeated in plain PyTorch for the CPU tests
(`tests/test_torch_msda_bwd_windowed.py`) and for
`tools/probe_torch_msda_bwd_bound.py`, which logs the share of the adds that
its windows take. Nothing in `mp_former_tpu_torch` uses it.
"""

from __future__ import annotations

import functools
import itertools
from typing import Sequence, Tuple

import torch

from mp_former_tpu_torch.ops.msda_cuda import (CHANNELS, _gather_taps, _level_starts,
                                               _tap_geometry, _work_dtype)


def _backward_parts(grad_out, value, spatial_shapes, sampling_locations, attention_weights):
    """grad_loc and grad_attn of `ms_deform_attn_backward_plain`, and what its
    grad_value scatters: per tap (B, Q, M, L, P, 2, 2) its token and the
    weight of its add, and g (B, Q, M, D)."""
    B, S, M, D = value.shape
    Q = sampling_locations.shape[1]
    (idx, bx, by, sx, sy, valid, W, H), a, w_row, w_col = _tap_weights(
        spatial_shapes, sampling_locations, attention_weights)
    g = grad_out.to(bx.dtype).view(B, Q, M, D)
    taps = _gather_taps(value, idx)                                  # (B, M, Q, K, D)
    d = (taps * g.permute(0, 2, 1, 3)[:, :, :, None, :]).sum(-1)      # (B, M, Q, K)
    del taps
    d = d.view(B, M, Q, *idx.shape[3:]).permute(0, 2, 1, 3, 4, 5, 6)  # (B, Q, M, L, P, 2, 2)
    rows = (d * bx[..., None, :]).sum(-1)                            # per tap row: sum over x
    grad_attn = (by * rows).sum(-1) * valid
    grad_x = a * W * (by * (d * sx[..., None, :]).sum(-1)).sum(-1)
    grad_y = a * H * (sy * rows).sum(-1)
    w = w_row[..., :, None] * w_col[..., None, :]                   # (B, Q, M, L, P, 2, 2)
    return idx, w, g, torch.stack([grad_x, grad_y], -1), grad_attn


# the window-stationary design's block map and windows
# (tools/probe_torch_msda_bwd_windows.cu): kTile, kMaxMargin, kMaxLevels,
# kSmemBytes, the bytes of its `Level` and of a window pixel (32 float32)
BWD_TILE, BWD_MAX_MARGIN, BWD_MAX_LEVELS = 16, 4, 4
BWD_SMEM_BYTES, BWD_LEVEL_BYTES, BWD_PIXEL_BYTES = 110 * 1024, 48, 4 * CHANNELS


@functools.lru_cache(maxsize=64)
def bwd_plan(shapes: Tuple[Tuple[int, int], ...], Q: int, window_pixels: int = -1):
    """The window-stationary design's plan (`make_plan` in
    tools/probe_torch_msda_bwd_windows.cu): where Q == S the tiles in rows
    and columns (kTile x kTile tiles of the level with the most pixels) and
    each level's window (rows, columns), the tile's extent on the level plus
    the largest margin up to kMaxMargin for which all windows fit
    `window_pixels` (its shared memory by default); if none does, the largest
    windows are dropped (the last of equals first). Levels past kMaxLevels,
    and every level where Q != S, get (0, 0)."""
    L, S = len(shapes), sum(h * w for h, w in shapes)
    if window_pixels < 0:
        window_pixels = (BWD_SMEM_BYTES - BWD_LEVEL_BYTES * L) // BWD_PIXEL_BYTES
    if Q != S:
        return 0, 0, ((0, 0),) * L
    hf, wf = shapes[max(range(L), key=lambda l: (shapes[l][0] * shapes[l][1], -l))]
    ty, tx = -(-hf // BWD_TILE), -(-wf // BWD_TILE)
    nl = min(L, BWD_MAX_LEVELS)
    for margin in range(BWD_MAX_MARGIN, -1, -1):
        dims = [(min(-(-h // ty) + 2 * margin, h), min(-(-w // tx) + 2 * margin, w))
                for h, w in shapes[:nl]]
        if sum(h * w for h, w in dims) <= window_pixels:
            break
    while sum(h * w for h, w in dims) > window_pixels:
        big = max(range(nl), key=lambda l: (dims[l][0] * dims[l][1], l))
        dims[big] = (0, 0)
    return ty, tx, tuple(dims) + ((0, 0),) * (L - nl)


@functools.lru_cache(maxsize=16)
def bwd_tiles(shapes: Tuple[Tuple[int, int], ...], ty: int, tx: int):
    """Per tile (row-major over ty x tx) and level the tile's rows and columns
    [r0, r1, c0, c1] (T, L, 4), and each token's tile (S,), as lists."""
    ranges, tile_of = [], [0] * sum(h * w for h, w in shapes)
    for i in range(ty):
        for j in range(tx):
            ranges.append([(i * h // ty, (i + 1) * h // ty, j * w // tx, (j + 1) * w // tx)
                           for h, w in shapes])
    start = 0
    for l, (h, w) in enumerate(shapes):
        for t, rng in enumerate(ranges):
            r0, r1, c0, c1 = rng[l]
            for r in range(r0, r1):
                for c in range(c0, c1):
                    tile_of[start + r * w + c] = t
        start += h * w
    return ranges, tile_of


def bwd_windows(spatial_shapes, sampling_locations: torch.Tensor, window_pixels: int = -1):
    """The window-stationary design's windows on tensors, or None where it
    has none (Q != S, or no window fits). Each block (b, tile, m) places each level's window from
    its points on that level: the mean of their offsets from the tile's middle
    row and column, each offset floored to a pixel and clipped to the window's
    size (points whose location is not finite left out), rounded, the window
    centred on it and kept on the map. Returns per tap (B, Q, M, L, P, 2, 2)
    whether it lies in its block's window (its location counts and the level
    has a window) and its slot among the blocks' window pixels (B, T, M,
    pixels) flattened, and per slot its token."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    B, Q, M, L, P, _ = sampling_locations.shape
    ty, tx, dims = bwd_plan(shapes, Q, window_pixels)
    if not any(h for h, _ in dims):
        return None
    device = sampling_locations.device
    ranges, tile_of = bwd_tiles(shapes, ty, tx)
    T, npix = ty * tx, sum(h * w for h, w in dims)
    ranges = torch.tensor(ranges, dtype=torch.long, device=device)          # (T, L, 4)
    tile_of = torch.tensor(tile_of, dtype=torch.long, device=device)        # (Q,)
    wh, ww = (torch.tensor(d, dtype=torch.long, device=device) for d in zip(*dims))
    H, W = (torch.tensor(d, dtype=torch.long, device=device) for d in zip(*shapes))
    mid = torch.stack([(ranges[..., 0] + ranges[..., 1] - 1) // 2,
                       (ranges[..., 2] + ranges[..., 3] - 1) // 2], -1)    # (T, L, 2) rows, cols
    dtype = _work_dtype(sampling_locations)
    loc = sampling_locations.to(dtype)
    pix = torch.stack([loc[..., 1] * H.view(L, 1) - 0.5, loc[..., 0] * W.view(L, 1) - 0.5], -1)
    finite = torch.isfinite(pix).all(-1)                                   # (B, Q, M, L, P)
    size = torch.stack([wh, ww], -1).view(L, 1, 2).to(dtype)
    off = pix.floor() - mid[tile_of].view(1, Q, 1, L, 1, 2)
    off = torch.where(finite[..., None], torch.minimum(torch.maximum(off, -size), size),
                      torch.zeros((), dtype=dtype, device=device)).long()
    sums = torch.zeros((B, T, M, L, 3), dtype=torch.long, device=device)
    sums.index_add_(1, tile_of, torch.cat([off.sum(4), finite.sum(4, keepdim=True)], -1))
    n = sums[..., 2:]
    shift = torch.where(n > 0, torch.div(sums[..., :2] + n // 2, n.clamp(min=1),
                                         rounding_mode="floor"), 0)
    first = mid.view(1, T, 1, L, 2) + shift - (torch.stack([wh, ww], -1) - 1) // 2
    first = torch.minimum(torch.maximum(first, torch.zeros_like(first)),
                          torch.stack([H - wh, W - ww], -1))                # (B, T, M, L, 2)
    # taps: rows y0, y0 + 1 and columns x0, x0 + 1 against the window's
    base = pix.floor()[..., None, :] + torch.tensor([0.0, 1.0], dtype=dtype,
                                                    device=device).view(2, 1)
    rel = base - first[:, tile_of].view(B, Q, M, L, 1, 1, 2)                # (B, Q, M, L, P, 2, 2)
    inside = (rel >= 0) & (rel < size.view(L, 1, 1, 2))
    valid = ((pix.floor() >= -1)
             & (pix.floor() <= torch.stack([H, W], -1).view(L, 1, 2).to(dtype) - 1)).all(-1)
    in_win = (inside[..., :, None, 0] & inside[..., None, :, 1]
              & (valid & (wh > 0).view(L, 1))[..., None, None])
    woff = torch.tensor([0] + list(itertools.accumulate(h * w for h, w in dims))[:-1],
                        dtype=torch.long, device=device)
    rel = torch.where(in_win[..., None], torch.stack(torch.broadcast_tensors(
        rel[..., :, None, 0], rel[..., None, :, 1]), -1), torch.zeros((), dtype=dtype,
                                                                      device=device)).long()
    block = ((torch.arange(B, device=device).view(B, 1, 1) * T + tile_of.view(1, Q, 1)) * M
             + torch.arange(M, device=device).view(1, 1, M))               # (B, Q, M)
    slot = (block.view(B, Q, M, 1, 1, 1, 1) * npix + woff.view(L, 1, 1, 1)
            + rel[..., 0] * ww.view(L, 1, 1, 1) + rel[..., 1])
    # per slot its token
    starts = torch.tensor(_level_starts(shapes), dtype=torch.long, device=device)
    tokens = []
    for l, (h, w) in enumerate(dims):
        if h:
            r = torch.arange(h, device=device).view(h, 1) + first[..., l, 0, None, None]
            c = torch.arange(w, device=device).view(1, w) + first[..., l, 1, None, None]
            tokens.append((starts[l] + r * shapes[l][1] + c).flatten(-2))
    return in_win, slot, torch.cat(tokens, -1)         # per slot its token: (B, T, M, npix)


def window_tap_share(spatial_shapes, sampling_locations: torch.Tensor,
                     attention_weights: torch.Tensor, window_pixels: int = -1) -> float:
    """The share of the window-stationary design's adds (taps on the map with
    a weight that is not 0, of points that count) that fall inside their
    block's window and are summed in shared memory; 0 where it has no
    windows."""
    _, _, w_row, w_col = _tap_weights(spatial_shapes, sampling_locations, attention_weights)
    adds = (w_row[..., :, None] * w_col[..., None, :]) != 0
    windows = bwd_windows(spatial_shapes, sampling_locations, window_pixels)
    if windows is None or not adds.any():
        return 0.0
    return ((windows[0] & adds).sum() / adds.sum()).item()


def _tap_weights(spatial_shapes, sampling_locations, attention_weights):
    """The geometry and, per point, a (attention x validity) with the
    bilinear factors of its rows a * by and columns bx."""
    geo = _tap_geometry(spatial_shapes, sampling_locations)
    a = attention_weights.to(geo[1].dtype) * geo[5]
    return geo, a, a[..., None] * geo[2], geo[1]


def ms_deform_attn_backward_windowed(grad_out: torch.Tensor, value: torch.Tensor,
                                     spatial_shapes: Sequence[Tuple[int, int]],
                                     sampling_locations: torch.Tensor,
                                     attention_weights: torch.Tensor,
                                     window_pixels: int = -1):
    """`ms_deform_attn_backward_plain` with grad_value summed the way the
    window-stationary design sums it (tools/probe_torch_msda_bwd_windows.cu),
    for the tests: the blocks' windows (`bwd_windows`), the adds of the taps
    inside a window summed per window pixel and flushed to grad_value once,
    the taps outside added straight to grad_value. Where Q != S there are no
    windows. `window_pixels` overrides the shared memory's room (-1: the
    design's). Returns what the plain backward returns."""
    B, S, M, D = value.shape
    Q = sampling_locations.shape[1]
    idx, w, g, grad_loc, grad_attn = _backward_parts(grad_out, value, spatial_shapes,
                                                     sampling_locations, attention_weights)
    adds = w[..., None] * g.view(B, Q, M, 1, 1, 1, 1, D)
    # rows of grad_value seen as (B * M * S, D)
    bm = (torch.arange(B, device=value.device).view(B, 1) * M
          + torch.arange(M, device=value.device).view(1, M)) * S         # (B, M)
    flat = bm.view(B, 1, M, 1, 1, 1, 1) + idx
    grad_value = torch.zeros((B * M * S, D), dtype=g.dtype, device=value.device)
    windows = bwd_windows(spatial_shapes, sampling_locations, window_pixels)
    if windows is None:
        grad_value.index_add_(0, flat.reshape(-1), adds.reshape(-1, D))
    else:
        in_win, slot, slot_token = windows
        grad_value.index_add_(0, flat[~in_win], adds[~in_win])
        window = torch.zeros((slot_token.numel(), D), dtype=g.dtype, device=value.device)
        window.index_add_(0, slot[in_win], adds[in_win])
        # the flush: every window pixel once, into its (batch, head, token)
        grad_value.index_add_(0, (bm.view(B, 1, M, 1) + slot_token).reshape(-1), window)
    grad_value = grad_value.view(B, M, S, D).permute(0, 2, 1, 3).contiguous()
    return grad_value, grad_loc, grad_attn
