"""K1's folded arithmetic, in plain PyTorch, against the plain version and
against the JAX package.

The CUDA kernel (`csrc/msda_fwd.cu`) clamps every tap index onto the map and
folds bilinear weight x validity x attention weight into four tap weights;
`ms_deform_attn_folded` does the same in PyTorch, so the edge cases of that
formulation are tested here on the CPU. The kernel itself is held against both
plain functions on the card (`chip_smoke.py`, tests/test_torch_kernels_gpu.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn as jax_ms_deform_attn

from mp_former_tpu_torch.ops.msda_cuda import ms_deform_attn_folded, ms_deform_attn_plain

torch.set_num_threads(2)

# float32 on all sides. The three compute the bilinear weights and sum in
# other orders: a few ulp of outputs of magnitude ~1.
TOL = 1e-5

SHAPES = [(6, 9), (3, 5), (2, 2)]


def _base(seed, B, Q, M, D, shapes, P):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    attn = rng.rand(B, Q, M, len(shapes) * P).astype(np.float32) + 1e-3
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(B, Q, M, len(shapes), P)
    loc = rng.uniform(-0.2, 1.2, (B, Q, M, len(shapes), P, 2)).astype(np.float32)
    return rng, value, loc, attn


def _sizes(shapes):
    """(L, 1, 2) float32: (W, H) per level."""
    return np.array([[w, h] for h, w in shapes], np.float32)[:, None, :]


def _locations(kind, rng, loc, shapes):
    """Sampling locations (B, Q, M, L, P, 2) that exercise one edge of the
    folded formulation."""
    wh = _sizes(shapes)
    if kind == "random":
        return loc
    if kind == "exactly_0_and_1":
        return rng.randint(0, 2, loc.shape).astype(np.float32)
    if kind == "pixel_centres":
        px = np.floor(rng.uniform(0, 1, loc.shape) * wh)
        return ((px + 0.5) / wh).astype(np.float32)
    if kind == "pixel_corners":
        return (np.floor(rng.uniform(0, 1, loc.shape) * (wh + 1)) / wh).astype(np.float32)
    if kind == "just_outside":
        # up to a pixel and a half beyond each side: the last taps on the map,
        # and the first points with none
        side = rng.randint(0, 2, loc.shape).astype(np.float32)
        beyond = rng.uniform(0, 1.5, loc.shape).astype(np.float32) / wh
        return (side + (2 * side - 1) * beyond).astype(np.float32)
    if kind == "far_outside":
        sign = rng.choice([-1.0, 1.0], loc.shape)
        return (sign * rng.uniform(3, 1e6, loc.shape)).astype(np.float32)
    if kind == "mixed":
        far = rng.rand(*loc.shape[:-1], 1) < 0.3
        return np.where(far, loc * 50 - 20, loc).astype(np.float32)
    raise ValueError(kind)


def _three_ways(value, shapes, loc, attn):
    args = [torch.from_numpy(a) for a in (value, loc, attn)]
    folded = ms_deform_attn_folded(args[0], shapes, args[1], args[2]).numpy()
    plain = ms_deform_attn_plain(args[0], shapes, args[1], args[2]).numpy()
    jax_out = np.asarray(jax.jit(lambda v, l, a: jax_ms_deform_attn(v, shapes, l, a))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn)))
    return folded, plain, jax_out


@pytest.mark.parametrize("kind", ["random", "exactly_0_and_1", "pixel_centres", "pixel_corners",
                                  "just_outside", "far_outside", "mixed"])
def test_folded_matches_plain_and_jax_at_the_edges(kind):
    rng, value, loc, attn = _base(0, 2, 23, 4, 8, SHAPES, 3)
    loc = _locations(kind, rng, loc, SHAPES)
    folded, plain, jax_out = _three_ways(value, SHAPES, loc, attn)
    assert folded.shape == (2, 23, 4 * 8) and np.isfinite(folded).all()
    np.testing.assert_allclose(folded, plain, rtol=0, atol=TOL)
    np.testing.assert_allclose(folded, jax_out, rtol=0, atol=TOL)
    if kind == "far_outside":
        np.testing.assert_array_equal(folded, 0.0)


@pytest.mark.parametrize("shapes,P,M,D", [
    ([(1, 1)], 2, 2, 4),                      # a 1x1 level alone
    ([(4, 6), (1, 1)], 3, 2, 4),              # a 1x1 level after another
    ([(5, 7), (3, 4), (2, 2)], 1, 4, 8),      # P = 1
    ([(7, 5)], 4, 4, 8),                      # L = 1
    ([(6, 8), (3, 4)], 2, 1, 32),             # M = 1
    ([(6, 8), (3, 4)], 2, 3, 32),             # M = 3
    ([(1, 9), (9, 1)], 2, 3, 4),              # single rows and columns
])
@pytest.mark.parametrize("kind", ["random", "just_outside"])
def test_folded_matches_plain_and_jax_at_odd_shapes(shapes, P, M, D, kind):
    rng, value, loc, attn = _base(1, 2, 19, M, D, shapes, P)
    loc = _locations(kind, rng, loc, shapes)
    folded, plain, jax_out = _three_ways(value, shapes, loc, attn)
    assert folded.shape == (2, 19, M * D)
    np.testing.assert_allclose(folded, plain, rtol=0, atol=TOL)
    np.testing.assert_allclose(folded, jax_out, rtol=0, atol=TOL)


def test_folded_gives_zero_for_locations_that_are_not_finite():
    """The kernel's rule: such a point contributes nothing (grid_sample
    returns NaN there, so only the finite rows are compared)."""
    rng, value, loc, attn = _base(2, 1, 8, 2, 4, SHAPES, 2)
    loc[0, 0] = np.nan
    loc[0, 1] = np.inf
    loc[0, 2, :, :, :, 0] = -np.inf
    folded = ms_deform_attn_folded(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                                   torch.from_numpy(attn)).numpy()
    plain = ms_deform_attn_plain(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                                 torch.from_numpy(attn)).numpy()
    np.testing.assert_array_equal(folded[0, :3], 0.0)
    np.testing.assert_allclose(folded[0, 3:], plain[0, 3:], rtol=0, atol=TOL)


def test_folded_keeps_the_input_type():
    _, value, loc, attn = _base(3, 1, 5, 2, 32, SHAPES, 2)
    args = [torch.from_numpy(a).bfloat16() for a in (value, loc, attn)]
    got = ms_deform_attn_folded(args[0], SHAPES, args[1], args[2])
    want = ms_deform_attn_plain(args[0].float(), SHAPES, args[1].float(), args[2].float())
    assert got.dtype == torch.bfloat16
    # the result is rounded to bfloat16: 8 bits of mantissa of outputs of magnitude ~1
    assert (got.float() - want).abs().max().item() <= 2e-2


def _init_locations(rng, B, Q, M, shapes, P):
    """Sampling locations (B, Q, M, L, P, 2) as the reference init gives them:
    pixel centres in float32 as the encoder's reference points, (j + 0.5) / W,
    moved by whole pixels (the offsets' bias, their weights being 0)."""
    loc = np.empty((B, Q, M, len(shapes), P, 2), np.float32)
    for lid, (h, w) in enumerate(shapes):
        for axis, n in ((0, w), (1, h)):
            centre = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
            step = rng.randint(-2, 3, (B, Q, M, P)).astype(np.float32) / np.float32(n)
            loc[:, :, :, lid, :, axis] = centre[rng.randint(0, n, (B, Q, M, P))] + step
    return loc


def test_plain_gradients_match_jax_at_the_reference_init():
    """At the reference init every sampling location is a pixel centre, where
    the bilinear map's derivative in the location jumps. The JAX package
    rounds the pixel coordinate as loc * W, then - 0.5; grid_sample's
    ((2 loc - 1 + 1) W - 1) / 2 floors some of those centres to the other side
    on levels whose size is no power of two (here the video training canvas's
    two coarse levels). Autograd of the plain version against the JAX VJP;
    fails with grid_sample's arithmetic (grad_loc 1.2 of its largest entry
    off)."""
    shapes = [(15, 42), (30, 84)]
    rng, value, _, attn = _base(4, 1, 64, 2, 8, shapes, 4)
    loc = _init_locations(rng, 1, 64, 2, shapes, 4)
    wh = _sizes(shapes)
    grid_sample_x = (((2 * loc - 1) + 1) * wh - 1) / 2
    assert (np.floor(loc * wh - 0.5) != np.floor(grid_sample_x)).mean() > 1e-3  # the case
    grad_out = rng.randn(1, 64, 2 * 8).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (value, loc, attn)]
    got = torch.autograd.grad(ms_deform_attn_plain(leaves[0], shapes, leaves[1], leaves[2]),
                              leaves, torch.from_numpy(grad_out))
    # op by op, as the source rounds: under jit XLA's CPU compiler contracts
    # loc * W - 0.5 into one FMA, which floors a few centres otherwise again
    want = jax.vjp(lambda *x: jax_ms_deform_attn(x[0], shapes, x[1], x[2]),
                   value, loc, attn)[1](grad_out)
    for name, g, w in zip(("value", "loc", "attn"), got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name
