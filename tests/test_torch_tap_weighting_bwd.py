"""Training through K2: the gradient of tap weighting, of both sampling routes
that use it, and one training step of the TPU recipe, against the JAX package.

- `weight_taps_backward_plain` (what the CUDA backward kernel computes) and
  autograd of the port's `weight_taps` on the CPU against `jax.vjp` of the
  JAX package's `weight_taps` (its custom_vjp `_bwd`), at both call shapes of
  a training step: head-shared rows (M = 8) and the per-head patch tables as
  the batch (M = 1).
- The gradients in value, locations and attention weights of
  `ms_deform_attn_headshare` (both formulations) and of the per-head
  patch-table route `ms_deform_attn(..., pallas_weighting=True)` against
  `jax.vjp` of their JAX counterparts, locations partly off the map.
- One training step of the TPU recipe (`..._DN_query_tpu.yaml`: head-shared
  sampling, tap weighting) in float32 at `SMALL` width, against the JAX
  package's step, by the checks and tolerances of
  tests/test_torch_train_step.py.

On the CPU the port runs K2's plain version and autograd gives its backward;
the CUDA backward kernel is held against `weight_taps_backward_plain` in
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp_former_tpu.ops.tap_weighting as jtw
from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn as jax_ms_deform_attn
from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn_headshare as jax_headshare

from mp_former_tpu_torch.ops import tap_weighting as tw
from mp_former_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_headshare

from test_torch_headshare import FLOAT32, TPU_CONFIG, _inputs
from test_torch_train_step import TRAIN, check_gradients, check_losses, check_parameters, one_step

torch.set_num_threads(2)

# float32 on both sides: the sums over d (grad_w) and over the gathered rows
# (grad_value) run in another order; relative to each gradient's largest entry
TOL = 1e-5
# (b, q, n_points, n_heads, d): the two call shapes of a step, cut in Q
CALL_SHAPES = [(2, 40, 4, 8, 32),    # head-shared: rows of 4 taps x 8 heads x 32
               (16, 40, 4, 1, 32)]   # per-head: B * M tables, rows of 4 taps x 32


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_vjp(fn, primals, cotangent):
    """The JAX package's gradients of fn at `primals`, jitted."""
    return jax.jit(lambda p, g: jax.vjp(fn, *p)[1](g))(primals, cotangent)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_taps_backward_matches_jax_vjp(dtype):
    """float32: within TOL. bfloat16: the JAX `_bwd` and the plain backward
    round the same float32 products (grad_taps equal, grad_w within an ulp
    of bfloat16); autograd of the plain forward rounds each product of
    grad_w to bfloat16 before the sum. Each side's distance from the float32
    gradient is held to twice the JAX package's own bfloat16 distance."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for b, q, n_points, n_heads, d in CALL_SHAPES:
        rng = np.random.RandomState(b + n_heads)
        taps = rng.randn(b, n_points * q, 4 * n_heads * d).astype(np.float32)
        w = (rng.rand(b, n_points * q, 4 * n_heads) ** 3).astype(np.float32)
        g = rng.randn(b, q, n_heads * d).astype(np.float32)
        fn = lambda t, x: jtw.weight_taps(t, x, n_points, n_heads, d)  # noqa: E731
        want32 = _jax_vjp(fn, (jnp.asarray(taps), jnp.asarray(w)), jnp.asarray(g))
        jax16 = _jax_vjp(fn, (jnp.asarray(taps, jdt), jnp.asarray(w, jdt)), jnp.asarray(g, jdt))
        t_taps, t_w, t_g = (torch.from_numpy(a).to(tdt) for a in (taps, w, g))
        plain = tw.weight_taps_backward_plain(t_taps, t_w, t_g, n_points, n_heads, d)
        leaves = [t_taps.clone().requires_grad_(), t_w.clone().requires_grad_()]
        auto = torch.autograd.grad(tw.weight_taps(*leaves, n_points, n_heads, d), leaves, t_g)
        for name, want, jx, pl, au, like in zip(("taps", "w"), want32, jax16, plain, auto,
                                                 (t_taps, t_w)):
            assert pl.dtype == au.dtype == tdt and pl.shape == au.shape == like.shape, name
            pl, au = pl.float().numpy(), au.float().numpy()
            if dtype == "float32":
                assert _rel(pl, want) <= TOL and _rel(au, want) <= TOL, (name, b, n_heads)
            else:
                own = _rel(np.asarray(jx, np.float32), want)
                assert 0 < own < 1e-2, (name, own)
                assert _rel(pl, want) <= 2 * own and _rel(au, want) <= 2 * own, (name, b, n_heads)
                assert _rel(pl, np.asarray(jx, np.float32)) <= 2 ** -7, (name, b, n_heads)


@pytest.mark.parametrize("route", ["headshare", "headshare_tap_weighting", "per_head_tap_weighting"])
def test_sampling_route_gradients_match_jax_vjp(route):
    """Gradients in value, locations and attention weights, float32, within
    TOL of each gradient's largest entry. The locations' gradient is the
    slope of the bilinear weights, differentiable as JAX's are; the gather's
    is a scatter-add on both sides."""
    shapes, P, D, M = [(16, 16), (8, 8), (4, 4)], 4, 8, 4
    shared = route != "per_head_tap_weighting"
    value, loc, attn = _inputs(7, 2, 37, M, D, shapes, P, shared=shared)
    g = np.random.RandomState(8).randn(2, 37, M * D).astype(np.float32)
    if route == "per_head_tap_weighting":
        jfn = lambda v, l, a: jax_ms_deform_attn(v, shapes, l, a, pallas_weighting=True)  # noqa: E731
        tfn = lambda v, l, a: ms_deform_attn(v, shapes, l, a, pallas_weighting=True)  # noqa: E731
    else:
        pw = route == "headshare_tap_weighting"
        jfn = lambda v, l, a: jax_headshare(v, shapes, l, a, pallas_weighting=pw)  # noqa: E731
        tfn = lambda v, l, a: ms_deform_attn_headshare(v, shapes, l, a, pallas_weighting=pw)  # noqa: E731
    want = _jax_vjp(jfn, tuple(jnp.asarray(a) for a in (value, loc, attn)), jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (value, loc, attn)]
    launches = (tw.LAUNCHES, tw.BWD_LAUNCHES)
    got = torch.autograd.grad(tfn(*leaves), leaves, torch.from_numpy(g))
    assert (tw.LAUNCHES, tw.BWD_LAUNCHES) == launches  # CPU tensors: the plain versions
    for name, x, w in zip(("value", "locations", "weights"), got, want):
        assert x.shape == w.shape, name
        assert np.abs(np.asarray(w)).max() > 0, name
        assert _rel(x.numpy(), w) <= TOL, (name, _rel(x.numpy(), w))


# weights and image of the step. Seed 0 (the released recipe's test) puts one
# input of an encoder FFN's ReLU at -1.6e-7 in the port and above 0 in the
# JAX package: ReLU's derivative differs there, and so does linear1's gradient
# (by 2% of its largest entry); with that one input's sign flipped every
# gradient agrees within 4e-5. Seed 3 keeps every FFN input clear of 0, which
# the test asserts.
STEP_SEED = 3
# the forwards of the two packages agree to ~1e-7 at the FFN inputs
RELU_MARGIN = 1e-6


def _smallest_ffn_input(model, batch):
    """The smallest |input| of the FFNs' ReLUs (encoder and decoder) in the
    step's forward."""
    from mp_former_tpu_torch.engine.train_step import compute_dn_groups

    seen = []
    hooks = [m.register_forward_hook(lambda mod, i, o: seen.append(o.abs().min().item()))
             for n, m in model.named_modules() if n.endswith("linear1")]
    with torch.no_grad():
        model(batch.images, batch.targets, generator=torch.Generator().manual_seed(0),
              dn_groups=compute_dn_groups(model.scalar, batch.targets.valid, 1))
    for h in hooks:
        h.remove()
    return min(seen)


def test_tpu_recipe_training_step_matches_jax():
    """One step of the TPU recipe in float32 (head-shared sampling through
    K2's plain version and its autograd backward, tap weighting on): losses,
    gradients leaf by leaf and parameters after one AdamW step, as
    tests/test_torch_train_step.py holds the released recipe."""
    step = one_step(TRAIN + FLOAT32, TPU_CONFIG, STEP_SEED)
    cfg = step["tcfg"]
    assert cfg.TPU.SAMPLING_ENGINE == "headshare" and cfg.TPU.PALLAS_TAP_WEIGHTING
    attn = step["model"].sem_seg_head.pixel_decoder.transformer.encoder.layers[0].self_attn
    assert attn.headshare and attn.pallas_weighting
    assert attn.sampling_offsets.weight.grad.abs().max() > 0
    assert _smallest_ffn_input(step["start"], step["batch"]) > RELU_MARGIN
    check_losses(step)
    check_gradients(step)
    check_parameters(step)
