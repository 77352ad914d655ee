"""K1 backward's window-stationary design (`tools/probe_torch_msda_bwd_windows.cu`,
a redesign measured on the card and not taken) on the CPU: its mirror
`ms_deform_attn_backward_windowed` in `tools/probe_torch_msda_bwd_windows.py`
(the kernel's block map, window rule, split of the taps inside and outside
the windows, and flush, on tensors) against the JAX package's gradients (`jax.vjp` of
`mp_former_tpu/ops/ms_deform_attn.py:ms_deform_attn`) and against the plain
backward; the plan (`bwd_plan`) and the share of the adds that the windows
take on locations made as `chip_smoke.py` makes them.

Tolerances, relative to each gradient's largest entry: 1e-4 against JAX in
float32 (other summation orders; points kept 1e-3 away from pixel borders,
where the gradient of a location jumps and the two sides round the sampling
coordinate differently), 1e-5 against the plain backward (the same
arithmetic; grad_value summed in another order).
"""

import numpy as np
import pytest
import torch

import jax

from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn as jax_ms_deform_attn

from mp_former_tpu_torch.ops import msda_cuda
from tools import probe_torch_msda_bwd_windows as windows

torch.set_num_threads(2)

TRAIN_LEVELS = ((16, 16), (32, 32), (64, 64))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(seed, B, Q, M, shapes, P, spread=3.0, far=0.02, special=False):
    """float32 numpy inputs. Where Q = S every token is a query and each point
    lies `spread` pixels (normal) off its token's centre, `far` of them 2
    (normalised) further, off the map; otherwise uniform from 0.2 below to 0.2
    above the map. No point within 1e-3 of a pixel border. `special`: a few
    points not finite, one far below the map, and a query's points all on one
    pixel."""
    rng = np.random.RandomState(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    sizes = np.array([[w, h] for h, w in shapes], np.float64).reshape(1, 1, 1, L, 1, 2)
    if Q == S:
        ref = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w,
                                                   (np.arange(h) + 0.5) / h), -1).reshape(-1, 2)
                              for h, w in shapes])
        loc = ref.reshape(1, S, 1, 1, 1, 2) + rng.randn(B, Q, M, L, P, 2) * spread / sizes
        loc = np.where(rng.rand(B, Q, M, L, P, 1) < far, loc + 2.0, loc)
    else:
        loc = rng.uniform(-0.2, 1.2, (B, Q, M, L, P, 2))
    pix = loc * sizes - 0.5
    frac = pix - np.floor(pix)
    loc = (np.floor(pix) + np.clip(frac, 1e-3, 1 - 1e-3) + 0.5) / sizes
    if special:
        loc[0, 0, 0, 0, 0] = np.nan
        loc[0, 1, 0, 0, 0] = np.inf
        loc[0, 2, 0, 0, 0] = -7.0
        loc[0, 3, 0] = ((np.array([[w // 2, h // 2] for h, w in shapes]) + 0.25)
                        / sizes[0, 0, 0, :, 0])[:, None]
    value = rng.randn(B, S, M, 32)
    attn = rng.rand(B, Q, M, L * P) + 1e-3
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(B, Q, M, L, P)
    grad_out = rng.randn(B, Q, M * 32)
    return tuple(a.astype(np.float32) for a in (value, loc, attn, grad_out))


def _windowed(value, loc, attn, grad_out, shapes, window_pixels=-1):
    return windows.ms_deform_attn_backward_windowed(
        torch.from_numpy(grad_out), torch.from_numpy(value), shapes, torch.from_numpy(loc),
        torch.from_numpy(attn), window_pixels=window_pixels)


# (shapes, B, M, P, Q or None for Q = S, spread in pixels, window pixels or -1)
CASES = {
    "tiles": (((8, 8), (16, 16), (32, 32)), 1, 2, 4, None, 3.0, -1),
    "far_outside": (((8, 8), (16, 16), (32, 32)), 2, 1, 3, None, 12.0, -1),
    "four_levels": (((13, 17), (7, 9), (4, 5), (2, 3)), 1, 2, 2, None, 2.0, -1),
    "overflow": (((8, 8), (16, 16), (32, 32)), 1, 2, 4, None, 3.0, 150),
    "q_not_s": (((9, 12), (5, 6)), 2, 3, 3, 40, 0.0, -1),
}


@pytest.mark.parametrize("case", ["tiles", "far_outside", "q_not_s"])
def test_windowed_backward_matches_jax_vjp(case):
    shapes, B, M, P, Q, spread, window_pixels = CASES[case]
    S = sum(h * w for h, w in shapes)
    value, loc, attn, grad_out = _inputs(1, B, Q or S, M, shapes, P, spread)

    @jax.jit
    def vjp(v, l, a, g):
        return jax.vjp(lambda v, l, a: jax_ms_deform_attn(v, shapes, l, a), v, l, a)[1](g)

    want = vjp(value, loc, attn, grad_out.reshape(B, Q or S, M * 32))
    got = _windowed(value, loc, attn, grad_out, shapes, window_pixels)
    for name, g, w in zip(("value", "loc", "attn"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) <= 1e-4, (case, name)


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_backward_matches_plain(case):
    """Also with points not finite, far below the map and all on one pixel;
    a window too small for every level (`overflow`) and no windows (Q != S)."""
    shapes, B, M, P, Q, spread, window_pixels = CASES[case]
    S = sum(h * w for h, w in shapes)
    value, loc, attn, grad_out = _inputs(2, B, Q or S, M, shapes, P, spread, special=True)
    got = _windowed(value, loc, attn, grad_out, shapes, window_pixels)
    want = msda_cuda.ms_deform_attn_backward_plain(*(torch.from_numpy(a) for a in (
        grad_out, value)), shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    for name, g, w in zip(("value", "loc", "attn"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert _rel(g, w) <= 1e-5, (case, name)
    # the points that do not count give nothing
    assert got[1][0, :3, 0, 0, 0].abs().max() == 0 and got[2][0, :3, 0, 0, 0].abs().max() == 0


def test_window_plan():
    """The tiles, margins and windows the design plans: at the training and
    the released batch's levels three windows of margin 3 (margin 4 does not
    fit 110 KB); past the room at margin 0 the largest window goes; none where
    Q != S or past kMaxLevels; the tiles part every level's tokens."""
    bs16 = ((32, 32), (64, 64), (128, 128))
    for shapes, tiles in ((TRAIN_LEVELS, (4, 4)), (bs16, (8, 8))):
        S = sum(h * w for h, w in shapes)
        assert windows.bwd_plan(shapes, S) == (*tiles, ((10, 10), (14, 14), (22, 22)))
    canvas = ((25, 34), (50, 68), (100, 136))
    assert windows.bwd_plan(canvas, 17850) == (7, 9, ((10, 10), (14, 14), (21, 22)))
    assert windows.bwd_plan(TRAIN_LEVELS, 5376, 300) == (4, 4, ((4, 4), (8, 8), (0, 0)))
    assert windows.bwd_plan(TRAIN_LEVELS, 5376, 10) == (4, 4, ((0, 0),) * 3)
    assert windows.bwd_plan(TRAIN_LEVELS, 100) == (0, 0, ((0, 0),) * 3)
    five = ((40, 40),) * 5
    ty, tx, dims = windows.bwd_plan(five, 8000)
    assert (ty, tx) == (3, 3) and dims[4] == (0, 0) and sum(h * w for h, w in dims) <= 880
    # the partition: every token in exactly one tile, every tile's extent as planned
    for shapes in (TRAIN_LEVELS, canvas, ((13, 17), (7, 9), (4, 5), (2, 3))):
        ty, tx, _ = windows.bwd_plan(shapes, sum(h * w for h, w in shapes))
        ranges, tile_of = windows.bwd_tiles(shapes, ty, tx)
        counts = np.bincount(tile_of, minlength=ty * tx)
        want = [sum((r1 - r0) * (c1 - c0) for r0, r1, c0, c1 in rng) for rng in ranges]
        assert counts.tolist() == want and sum(want) == len(tile_of)


def test_window_share_for_chip_smoke_locations():
    """At the training levels, locations as `chip_smoke.py` makes them (3
    pixels of noise, 2% far off the map): most adds go to a window. The
    initial offsets of `MSDeformAttn` (1-4 pixels along the head's direction)
    all do; uniform locations mostly do not."""
    from mp_former_tpu_torch.ops.ms_deform_attn import MSDeformAttn

    shapes, B, M, P = TRAIN_LEVELS, 1, 8, 4
    S, L = sum(h * w for h, w in shapes), len(shapes)
    _, noisy, attn, _ = _inputs(3, B, S, M, shapes, P)
    noisy, attn = torch.from_numpy(noisy), torch.from_numpy(attn)
    share = windows.window_tap_share(shapes, noisy, attn)
    assert 0.88 <= share <= 0.97, share
    sizes = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32).view(1, 1, 1, L, 1, 2)
    ref = noisy.new_tensor(np.concatenate([np.stack(np.meshgrid(
        (np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1).reshape(-1, 2)
        for h, w in shapes])).view(1, S, 1, 1, 1, 2)
    torch.manual_seed(0)
    bias = MSDeformAttn(M * 32, L, M, P).sampling_offsets.bias.detach()
    model = (ref + bias.view(1, 1, M, L, P, 2) / sizes).expand(B, S, M, L, P, 2)
    assert windows.window_tap_share(shapes, model, attn) == 1.0
    uniform = torch.from_numpy(np.random.RandomState(4).uniform(-0.1, 1.1, model.shape)
                               .astype(np.float32))
    assert windows.window_tap_share(shapes, uniform, attn) < 0.4
    # Q != S: no windows
    assert windows.window_tap_share(shapes, noisy[:, :100], attn[:, :100]) == 0.0


def test_windowed_split_reaches_both_paths():
    """The split is real: in `far_outside` some adds go to the windows and
    some straight to grad_value, every window slot names a token of its level
    on the map, and a window outside the windows' room gives the plain result
    through the direct path alone."""
    shapes, B, M, P, _, spread, _ = CASES["far_outside"]
    S = sum(h * w for h, w in shapes)
    value, loc, attn, grad_out = _inputs(5, B, S, M, shapes, P, spread)
    in_win, slot, slot_token = windows.bwd_windows(shapes, torch.from_numpy(loc))
    assert 0 < in_win.float().mean().item() < 0.9
    assert slot[in_win].min() >= 0 and slot[in_win].max() < slot_token.numel()
    assert slot_token.min() >= 0 and slot_token.max() < S
    assert windows.bwd_windows(shapes, torch.from_numpy(loc), 0) is None
    got = _windowed(value, loc, attn, grad_out, shapes, 0)
    want = msda_cuda.ms_deform_attn_backward_plain(*(torch.from_numpy(a) for a in (
        grad_out, value)), shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
