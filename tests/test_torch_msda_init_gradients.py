"""The gradients of K1's plain version at the reference init against the JAX
package's VJP (tests/test_torch_msda_folded.py holds the folded arithmetic).
Six tests at most a file: the Tier-1 run queues such files behind its longest
one (ROADMAP.md, "Tier-1's clock").
"""

import numpy as np
import torch

import jax

from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn as jax_ms_deform_attn

from mp_former_tpu_torch.ops.msda_cuda import ms_deform_attn_plain

from test_torch_msda_folded import _base, _sizes

torch.set_num_threads(2)


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
