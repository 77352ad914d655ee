"""The plain backwards of K1 and K3 (`ms_deform_attn_backward_plain`,
`masked_attention_backward_plain`): the formulas the CUDA backward kernels are
held against on the card, here against autograd of the plain forwards, finite
differences in float64, and the JAX package's gradients (`jax.vjp` of
`ms_deform_attn`; the einsum branch of its `MultiheadAttention`, which is what
it trains through). The autograd Functions that join the kernels are for CUDA
tensors; on the CPU the dispatchers take the plain forward and autograd.

Tolerances, relative to each gradient's largest entry: 1e-5 against autograd
and JAX in float32 (other summation orders; the test keeps sampling points a
hair away from pixel borders, where grid_sample and the kernels' arithmetic
round to different pixels), 1e-9 in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.models.transformer_decoder.primitives import \
    MultiheadAttention as JaxMultiheadAttention
from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn as jax_ms_deform_attn

from mp_former_tpu_torch.models.transformer_decoder.primitives import MultiheadAttention
from mp_former_tpu_torch.ops import masked_attention_cuda as mac
from mp_former_tpu_torch.ops import msda_cuda
from mp_former_tpu_torch.ops.ms_deform_attn import ms_deform_attn

torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _msda_inputs(seed, B, Q, M, D, shapes, P, dtype=np.float32):
    """Locations from 0.2 below to 0.2 above the map; none within 1e-3 of a
    pixel border, where the gradient of the location jumps."""
    rng = np.random.RandomState(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = rng.randn(B, S, M, D)
    sizes = np.array([[w, h] for h, w in shapes], np.float64).reshape(1, 1, 1, L, 1, 2)
    pix = rng.uniform(-0.2, 1.2, (B, Q, M, L, P, 2)) * sizes - 0.5
    frac = pix - np.floor(pix)
    pix = np.floor(pix) + np.clip(frac, 1e-3, 1 - 1e-3)
    loc = (pix + 0.5) / sizes
    attn = rng.rand(B, Q, M, L * P) + 1e-3
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(B, Q, M, L, P)
    grad_out = rng.randn(B, Q, M * D)
    return tuple(a.astype(dtype) for a in (value, loc, attn, grad_out))


MSDA_CASES = [([(6, 5), (3, 2)], 2, 2, 7, 3, 8), ([(8, 12), (4, 6), (2, 3)], 4, 1, 37, 8, 32),
              ([(1, 1), (5, 3)], 3, 2, 5, 1, 4)]


@pytest.mark.parametrize("shapes,P,B,Q,M,D", MSDA_CASES)
def test_msda_backward_plain_matches_autograd(shapes, P, B, Q, M, D):
    value, loc, attn, grad_out = (torch.from_numpy(a) for a in
                                  _msda_inputs(0, B, Q, M, D, shapes, P))
    leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
    # the dispatcher: CPU tensors take the plain forward, and autograd
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    want = torch.autograd.grad(out, leaves, grad_out)
    got = msda_cuda.ms_deform_attn_backward_plain(grad_out, value, shapes, loc, attn)
    for name, g, w in zip(("value", "loc", "attn"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) <= 1e-5, name


@pytest.mark.parametrize("shapes,P,B,Q,M,D", MSDA_CASES[:2])
def test_msda_backward_plain_matches_jax_vjp(shapes, P, B, Q, M, D):
    value, loc, attn, grad_out = _msda_inputs(1, B, Q, M, D, shapes, P)
    _, vjp = jax.vjp(lambda v, l, a: jax_ms_deform_attn(v, shapes, l, a),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    want = vjp(jnp.asarray(grad_out))
    got = msda_cuda.ms_deform_attn_backward_plain(*(torch.from_numpy(a) for a in
                                                    (grad_out, value)), shapes,
                                                  torch.from_numpy(loc), torch.from_numpy(attn))
    for name, g, w in zip(("value", "loc", "attn"), got, want):
        assert _rel(g, w) <= 1e-5, name


def test_msda_backward_plain_float64_finite_differences():
    """The three formulas against central differences of the plain forward."""
    shapes = [(4, 3), (2, 2)]
    value, loc, attn, grad_out = (torch.from_numpy(a) for a in
                                  _msda_inputs(2, 1, 3, 2, 4, shapes, 2, np.float64))
    got = msda_cuda.ms_deform_attn_backward_plain(grad_out, value, shapes, loc, attn)
    assert all(g.dtype == torch.float64 for g in got)

    def loss(v, l, a):
        return (msda_cuda.ms_deform_attn_plain(v, shapes, l, a) * grad_out).sum()

    eps = 1e-6
    for i, (g, x) in enumerate(zip(got, (value, loc, attn))):
        numeric = torch.zeros_like(x).reshape(-1)
        for j in range(x.numel()):
            d = torch.zeros_like(x).reshape(-1)
            d[j] = eps
            args_hi, args_lo = [value, loc, attn], [value, loc, attn]
            args_hi[i], args_lo[i] = x + d.view_as(x), x - d.view_as(x)
            numeric[j] = (loss(*args_hi) - loss(*args_lo)) / (2 * eps)
        assert _rel(g, numeric.view_as(x)) <= 1e-7, i
    leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
    assert torch.autograd.gradcheck(
        lambda v, l, a: msda_cuda.ms_deform_attn_plain(v, shapes, l, a), leaves, eps=1e-6,
        atol=1e-6)


def test_msda_backward_plain_gives_nothing_to_points_off_the_map_or_not_finite():
    shapes = [(6, 5), (3, 2)]
    value, loc, attn, grad_out = (torch.from_numpy(a) for a in
                                  _msda_inputs(3, 1, 6, 2, 8, shapes, 2))
    loc[0, 0] = float("nan")
    loc[0, 1] = float("inf")
    loc[0, 2] = -7.0
    loc[0, 3] = 1e30
    gv, gl, ga = msda_cuda.ms_deform_attn_backward_plain(grad_out, value, shapes, loc, attn)
    assert torch.isfinite(gv).all() and torch.isfinite(gl).all() and torch.isfinite(ga).all()
    assert gl[0, :4].abs().max() == 0 and ga[0, :4].abs().max() == 0
    # grad_value holds what the two live queries give, and nothing else
    live = msda_cuda.ms_deform_attn_backward_plain(grad_out[:, 4:], value, shapes, loc[:, 4:],
                                                   attn[:, 4:])[0]
    torch.testing.assert_close(gv, live, rtol=0, atol=1e-6)
    # a point with one column of taps off the map: only the column on the map counts
    loc2 = torch.full((1, 1, 1, 1, 1, 2), 0.5)
    loc2[..., 0] = 0.01                       # x = -0.45: x0 = -1 is off, x1 = 0 is on
    v2 = torch.arange(20, dtype=torch.float32).view(1, 20, 1, 1) + 1
    g2 = torch.ones(1, 1, 1)
    gv2, gl2, ga2 = msda_cuda.ms_deform_attn_backward_plain(g2, v2, [(4, 5)], loc2,
                                                            torch.ones(1, 1, 1, 1, 1))
    leaves = [t.clone().requires_grad_() for t in (v2, loc2)]
    out = msda_cuda.ms_deform_attn_plain(leaves[0], [(4, 5)], leaves[1], torch.ones(1, 1, 1, 1, 1))
    want = torch.autograd.grad(out, leaves, g2)
    torch.testing.assert_close(gv2, want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(gl2, want[1], rtol=1e-5, atol=1e-5)
    assert (gv2.view(4, 5)[:, 1:] == 0).all() and gv2.sum() > 0


def _attn_inputs(seed, B, H, Q, S, D, per_head, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, n, D).astype(dtype) for n in (Q, S, S))
    mask = rng.rand(*((B, H, Q, S) if per_head else (B, Q, S))) < 0.7
    mask[..., 0, :] = True     # a row blocked everywhere: uniform over the keys
    grad_out = rng.randn(B, H, Q, D).astype(dtype)
    return q, k, v, mask, grad_out


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("B,H,Q,S,D", [(2, 3, 5, 17, 8), (1, 8, 20, 130, 32), (2, 1, 1, 1, 4)])
def test_attention_backward_plain_matches_autograd(B, H, Q, S, D, per_head):
    q, k, v, mask, grad_out = (torch.from_numpy(a) for a in
                               _attn_inputs(0, B, H, Q, S, D, per_head))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = mac.masked_attention(*leaves, mask)   # CPU tensors: the plain forward
    want = torch.autograd.grad(out, leaves, grad_out)
    got = mac.masked_attention_backward_plain(grad_out, q, k, v, mask)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) <= 1e-5, name
    # the blocked row passes dO / S to every value row and nothing to q (or k)
    assert got[0][:, :, 0].abs().max() == 0
    if Q == 1:
        torch.testing.assert_close(got[2], (grad_out / S).expand(B, H, S, D), rtol=1e-6, atol=1e-7)
        assert got[1].abs().max() == 0


def test_attention_backward_plain_float64_gradcheck():
    q, k, v, mask, grad_out = (torch.from_numpy(a) for a in
                               _attn_inputs(1, 1, 2, 3, 6, 4, True, np.float64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(lambda a, b, c: mac.masked_attention_plain(a, b, c, mask),
                                    leaves, eps=1e-6, atol=1e-6)
    want = torch.autograd.grad(mac.masked_attention_plain(*leaves, mask), leaves, grad_out)
    got = mac.masked_attention_backward_plain(grad_out, q, k, v, mask)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-9


def test_cross_attention_gradients_match_jax():
    """The port's MultiheadAttention (CPU: K3's plain version and autograd)
    against the JAX module's einsum branch, which the JAX package trains
    through: gradients of the inputs and of every weight, with a per-head mask
    that has a row blocked everywhere."""
    B, Q, S, C, H = 2, 6, 33, 32, 4
    torch.manual_seed(0)
    mod = MultiheadAttention(C, H)
    with torch.no_grad():
        mod.in_proj_bias.normal_(0, 0.1)
        mod.out_proj.bias.normal_(0, 0.1)
    w, b = mod.in_proj_weight.detach().numpy(), mod.in_proj_bias.detach().numpy()
    params = {n: {"kernel": jnp.asarray(w[i * C:(i + 1) * C].T),
                  "bias": jnp.asarray(b[i * C:(i + 1) * C])}
              for i, n in enumerate(("q_proj", "k_proj", "v_proj"))}
    params["out_proj"] = {"kernel": jnp.asarray(mod.out_proj.weight.detach().numpy().T),
                          "bias": jnp.asarray(mod.out_proj.bias.detach().numpy())}
    rng = np.random.RandomState(2)
    query, key, value = (rng.randn(B, n, C).astype(np.float32) for n in (Q, S, S))
    mask = rng.rand(B, H, Q, S) < 0.7
    mask[:, :, 0] = True
    grad_out = rng.randn(B, Q, C).astype(np.float32)

    def jax_loss(p, qu, ke, va):
        out = JaxMultiheadAttention(C, H).apply({"params": p}, qu, ke, va, jnp.asarray(mask))
        return (out * grad_out).sum()

    want_p, want_q, want_k, want_v = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        params, jnp.asarray(query), jnp.asarray(key), jnp.asarray(value))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (query, key, value))
    (mod(tq, tk, tv, torch.from_numpy(mask)) * torch.from_numpy(grad_out)).sum().backward()
    for got, want in ((tq.grad, want_q), (tk.grad, want_k), (tv.grad, want_v)):
        assert _rel(got, want) <= 1e-5
    got_w = mod.in_proj_weight.grad.numpy()
    got_b = mod.in_proj_bias.grad.numpy()
    for i, n in enumerate(("q_proj", "k_proj", "v_proj")):
        assert _rel(got_w[i * C:(i + 1) * C].T, want_p[n]["kernel"]) <= 1e-5, n
        if n == "k_proj":
            # a shift of every key leaves the softmax as it is: the gradient is 0
            # in exact arithmetic and rounding noise in both packages
            assert np.abs(got_b[i * C:(i + 1) * C]).max() <= 1e-5 * np.abs(got_w).max()
        else:
            assert _rel(got_b[i * C:(i + 1) * C], want_p[n]["bias"]) <= 1e-5, n
    assert _rel(mod.out_proj.weight.grad.numpy().T, want_p["out_proj"]["kernel"]) <= 1e-5


def test_kernel_wrappers_refuse_cpu_tensors():
    """The raw wrappers of the backward kernels launch or raise: nothing on
    the CPU goes to them, and they do not fall back."""
    shapes = [(2, 2)]
    value, loc, attn, grad_out = (torch.from_numpy(a) for a in
                                  _msda_inputs(4, 1, 4, 1, 32, shapes, 1))
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_bwd(grad_out, value, shapes, loc, attn)
    q, k, v, mask, go = (torch.from_numpy(a) for a in _attn_inputs(2, 1, 1, 2, 3, 32, False))
    with pytest.raises(ValueError, match="CUDA"):
        mac.masked_attn_bwd(go, q, k, v, mask, go, torch.zeros(1, 1, 2, 2))
    assert msda_cuda.BWD_LAUNCHES == 0 and mac.BWD_LAUNCHES == 0
