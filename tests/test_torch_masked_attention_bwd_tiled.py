"""K3 backward's tiled arithmetic, in plain PyTorch, against the plain backward
and against the JAX package's gradient.

The CUDA kernel (`csrc/masked_attn_bwd.cu`) splits the keys into chunks of
64-key tiles, walks the queries in 32-row tiles, recomputes the weights from
the forward's row statistics, runs its float32 products as 3xTF32 (bfloat16:
P and dS rounded to bfloat16) and sums dQ over a chunk's tiles, then over the
chunks in order; `masked_attention_backward_tiled` does the same in PyTorch,
so the edge cases of that formulation are tested here on the CPU (ragged Q and
S, rows blocked everywhere, every split). The JAX side is `jax.vjp` of the
einsum form the JAX package trains through (`primitives.MultiheadAttention`
with identity projections, primitives.py:72-80). The kernel itself is held
against both plain functions on the card (`chip_smoke.py`,
tests/test_torch_kernels_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp_former_tpu.models.transformer_decoder.primitives import (
    MultiheadAttention as JaxMultiheadAttention)

from mp_former_tpu_torch.ops import masked_attention_cuda as mac

torch.set_num_threads(2)

# float32, relative to each gradient's largest entry: against the plain
# backward, 3xTF32 leaves the small x small term out (2^-22) and the tiles sum
# in another order; against JAX, the order of the sums only
TOL_PLAIN = 1e-5
TOL_JAX = 1e-4
# bfloat16: P and dS rounded to 8 bits of mantissa for the products
TOL_BF16 = 2e-2

H, D = 2, 32


def _inputs(seed, B, Q, S, per_head):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, n, D).astype(np.float32) for n in (Q, S, S, Q))
    mask = rng.rand(*((B, H, Q, S) if per_head else (B, Q, S))) < 0.7
    mask[:, ..., :1, :] = True  # every key blocked in the first row
    return q, k, v, g, mask


def _tiled(q, k, v, g, mask, dtype=torch.float32, **kw):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    mask = torch.from_numpy(mask)
    out, stats = mac.masked_attention_tiled(q, k, v, mask, with_stats=True)
    return mac.masked_attention_backward_tiled(g, q, k, v, mask, out, stats, **kw)


def _plain(q, k, v, g, mask):
    return mac.masked_attention_backward_plain(*(torch.from_numpy(a) for a in (g, q, k, v, mask)))


def _rel(got, want):
    """max |got - want| relative to want's largest entry, or absolute where
    that is below 1: with a single key, or every key blocked, dq and dk are 0 in
    exact arithmetic and rounding noise on both sides (inputs are of order 1)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _jax_vjp(q, k, v, g, mask):
    """The gradients of primitives.MultiheadAttention's einsum path with
    identity projections, i.e. of masked attention of q, k, v themselves."""
    B, _, Q, _ = q.shape
    mask4 = jnp.asarray(np.broadcast_to(mask[:, None] if mask.ndim == 3 else mask,
                                        (B, H, Q, k.shape[2])))
    eye = {"kernel": np.eye(H * D, dtype=np.float32), "bias": np.zeros(H * D, np.float32)}
    params = {name: eye for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
    module = JaxMultiheadAttention(H * D, H)

    def flat(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], H * D)

    def unflat(a, n):
        return np.asarray(a).reshape(B, n, H, D).transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(lambda a, b, c: module.apply({"params": params}, a, b, c, mask4),
                     flat(q), flat(k), flat(v))
    dq, dk, dv = vjp(flat(g))
    return unflat(dq, Q), unflat(dk, k.shape[2]), unflat(dv, k.shape[2])


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("Q", [1, 31, 33, 120])
@pytest.mark.parametrize("S", [1, 31, 33, 120])
def test_backward_tiled_matches_plain_and_jax(S, Q, per_head):
    B = 2
    q, k, v, g, mask = _inputs(S * 1000 + Q, B, Q, S, per_head)
    got = _tiled(q, k, v, g, mask)
    for x, want, n in zip(got, _plain(q, k, v, g, mask), (Q, S, S)):
        assert x.shape == (B, H, n, D) and torch.isfinite(x).all()
        assert _rel(x, want) <= TOL_PLAIN
    for x, want in zip(got, _jax_vjp(q, k, v, g, mask)):
        assert _rel(x, want) <= TOL_JAX
    # the row blocked everywhere passes nothing to its q, and dv gets dO / S from it
    assert (got[0][:, :, 0] == 0).all()


@pytest.mark.parametrize("chunk", [None, 64, 128, 320])
def test_backward_tiled_gives_one_result_for_every_split(chunk):
    q, k, v, g, mask = _inputs(7, 1, 40, 300, True)
    got = _tiled(q, k, v, g, mask, chunk=chunk)
    for x, want in zip(got, _plain(q, k, v, g, mask)):
        assert _rel(x, want) <= TOL_PLAIN


def test_backward_tiled_every_row_blocked():
    q, k, v, g, mask = _inputs(3, 1, 5, 70, False)
    mask[:] = True
    dq, dk, dv = _tiled(q, k, v, g, mask, chunk=64)
    assert (dq == 0).all() and (dk == 0).all()
    np.testing.assert_allclose(dv.numpy(), np.broadcast_to(g.sum(2, keepdims=True) / 70,
                                                           dv.shape), rtol=1e-5, atol=1e-6)


def test_backward_tiled_bfloat16_rounds_like_the_kernel():
    q, k, v, g, mask = _inputs(5, 2, 33, 100, True)
    got = _tiled(q, k, v, g, mask, dtype=torch.bfloat16)
    rounded = [a.astype(np.float32) for a in (torch.from_numpy(x).bfloat16().float().numpy()
                                              for x in (q, k, v, g))]
    want = _plain(*rounded, mask)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16
        assert _rel(x.float(), w) <= TOL_BF16


@pytest.mark.parametrize("S,Q,pairs,chunk", [(256, 120, 64, 64), (1024, 120, 64, 256),
                                             (4096, 120, 64, 1024), (13600, 100, 8, 448),
                                             (1, 1, 1, 64), (300, 600, 16, 64)])
def test_backward_chunk_size_on_132_sms(S, Q, pairs, chunk):
    """At the training shapes (64 (batch, head) pairs) the grid holds 256
    blocks, at most 2 an SM (one wave); a Q above 256 rows adds blocks along z."""
    assert mac._bwd_chunk_size(S, pairs * -(-Q // mac.BWD_MAX_ROWS), 132) == chunk


def test_backward_tiled_refuses_a_chunk_that_is_no_multiple_of_a_tile():
    q, k, v, g, mask = _inputs(1, 1, 4, 70, False)
    with pytest.raises(ValueError, match="no multiple of 64"):
        _tiled(q, k, v, g, mask, chunk=96)
