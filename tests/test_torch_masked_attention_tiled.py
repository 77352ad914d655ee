"""K3's tiled arithmetic, in plain PyTorch, against the plain version and
against the JAX package.

The CUDA kernel (`csrc/masked_attn_fwd.cu`) pads the query rows to 16-row
tiles, splits the keys into chunks, walks each chunk in 64-key tiles with an
online softmax in the base-2 domain (masked keys at -1e9, keys beyond the end
of S at -inf), runs its float32 products as 3xTF32 and merges the chunks by
their maxima; `masked_attention_tiled` does the same in PyTorch, so the edge
cases of that formulation are tested here on the CPU. The kernel itself is held
against both plain functions on the card (`chip_smoke.py`,
tests/test_torch_kernels_gpu.py). The JAX Pallas kernel runs as its own tests
run it on the CPU (`interpret=True`); the XLA path is that of
`primitives.MultiheadAttention` with identity projections.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp_former_tpu.models.transformer_decoder.primitives import (
    MultiheadAttention as JaxMultiheadAttention)
from mp_former_tpu.ops.fused_masked_attention import masked_attention as jax_masked_attention

from mp_former_tpu_torch.ops import masked_attention_cuda as mac

torch.set_num_threads(2)

# float32 against the plain version: 3xTF32 leaves the small x small term of
# each product out (2^-22 relative), and the tiles sum in another order
TOL_PLAIN = 2e-6
# float32 on both sides against JAX: summation order only
TOL_JAX = 1e-5

H, D = 2, 32


def _inputs(seed, B, Q, S, per_head):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, n, D).astype(np.float32) for n in (Q, S, S))
    mask = rng.rand(*((B, H, Q, S) if per_head else (B, Q, S))) < 0.7
    mask[:, ..., :1, :] = True  # every key blocked in the first row
    return q, k, v, mask


def _tiled(q, k, v, mask, **kw):
    return mac.masked_attention_tiled(*(torch.from_numpy(a) for a in (q, k, v, mask)), **kw).numpy()


def _plain(q, k, v, mask):
    return mac.masked_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()


def _mask4(mask, B, Q, S):
    return np.ascontiguousarray(np.broadcast_to(mask[:, None] if mask.ndim == 3 else mask,
                                                (B, H, Q, S)))


def _jax_xla_path(q, k, v, mask4):
    """primitives.MultiheadAttention's XLA path: identity projections, so the
    module computes masked attention of q, k, v themselves."""
    B, _, Q, _ = q.shape
    eye = {"kernel": np.eye(H * D, dtype=np.float32), "bias": np.zeros(H * D, np.float32)}
    params = {name: eye for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
    flat = [jnp.asarray(a.transpose(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], H * D))
            for a in (q, k, v)]
    out = JaxMultiheadAttention(H * D, H).apply({"params": params}, *flat, jnp.asarray(mask4))
    return np.asarray(out).reshape(B, Q, H, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("Q", [1, 7, 100, 130])
@pytest.mark.parametrize("S", [1, 31, 33, 77, 850])
def test_tiled_matches_plain_and_jax(S, Q, per_head):
    B = 2
    q, k, v, mask = _inputs(S * 1000 + Q, B, Q, S, per_head)
    got = _tiled(q, k, v, mask)
    assert got.shape == (B, H, Q, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, _plain(q, k, v, mask), rtol=0, atol=TOL_PLAIN)
    mask4 = _mask4(mask, B, Q, S)
    np.testing.assert_allclose(got, _jax_xla_path(q, k, v, mask4), rtol=0, atol=TOL_JAX)
    block_s = 170 if S == 850 else S  # the Pallas kernel wants whole blocks
    pallas = jax_masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(mask4), block_s=block_s, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=TOL_JAX)


@pytest.mark.parametrize("chunk", [None, 64, 192, 448, 1024])
@pytest.mark.parametrize("case", ["full_rows", "one_chunk_visible", "last_key_visible",
                                  "ragged_tile_masked", "every_chunk_masked"])
def test_tiled_with_fully_masked_rows_and_chunks(case, chunk):
    B, Q, S = 1, 21, 850
    q, k, v, mask = _inputs(5, B, Q, S, per_head=False)
    if case == "full_rows":
        mask[:, :4] = True
    elif case == "one_chunk_visible":  # every other chunk weighs exp(-1e9 - m) = 0
        mask[:, :, :64], mask[:, :, 64:] = False, True
    elif case == "last_key_visible":
        mask[:, :, :-1], mask[:, :, -1] = True, False
    elif case == "ragged_tile_masked":
        mask[:, :, :832], mask[:, :, 832:] = False, True
    else:
        mask[:] = True
    got = _tiled(q, k, v, mask, chunk=chunk)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _plain(q, k, v, mask), rtol=0, atol=TOL_PLAIN)
    mean = np.broadcast_to(v.mean(2, keepdims=True), got.shape)
    if case == "every_chunk_masked":  # uniform over all S keys, through every merge
        np.testing.assert_allclose(got, mean, rtol=0, atol=TOL_PLAIN)
    elif case == "last_key_visible":
        np.testing.assert_allclose(got[:, :, 1:], np.broadcast_to(v[:, :, -1:], got[:, :, 1:].shape),
                                   rtol=0, atol=TOL_PLAIN)
    elif case == "full_rows":
        np.testing.assert_allclose(got[:, :, :4], mean[:, :, :4], rtol=0, atol=TOL_PLAIN)


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("S", [850, 3400])
def test_tiled_gives_one_result_for_every_split(S, sms):
    """The wrapper's choice of chunk for cards of other sizes (one SM: a single
    chunk, no merge) changes the order of the sums only."""
    q, k, v, mask = _inputs(6, 1, 9, S, per_head=False)
    got = _tiled(q, k, v, mask, sms=sms)
    np.testing.assert_allclose(got, _plain(q, k, v, mask), rtol=0, atol=TOL_PLAIN)


def test_tiled_bfloat16_keeps_the_type():
    q, k, v, mask = _inputs(7, 2, 19, 200, per_head=True)
    args = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = mac.masked_attention_tiled(*args, torch.from_numpy(mask))
    want = mac.masked_attention_plain(*(a.float() for a in args), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    # weights and result rounded to bfloat16: 8 bits of mantissa of outputs of magnitude ~1
    assert (got.float() - want).abs().max().item() <= 2e-2


def test_tf32_rounding_and_split():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -1.0 - 2.0 ** -11,
                      1.0 + 2.0 ** -10, 3.14159265], dtype=torch.float32)
    r = mac._tf32(x)
    # to nearest, ties away from zero, 10 bits of mantissa
    np.testing.assert_array_equal(r[:5].numpy(), np.float32([1.0, 1.0 + 2.0 ** -10, 1.0,
                                                             -1.0 - 2.0 ** -10, 1.0 + 2.0 ** -10]))
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    small = mac._tf32(x - r)
    # big + small keeps 21 bits or more of x
    assert ((r + small) - x).abs().max().item() <= 2.0 ** -21 * 4


def test_product_3xtf32_is_close_to_float32():
    rng = np.random.RandomState(8)
    a, b = (torch.from_numpy(rng.randn(3, 40, 32).astype(np.float32)) for _ in range(2))
    got = mac._product_3xtf32("bqd,bsd->bqs", a, b)
    want = torch.einsum("bqd,bsd->bqs", a.double(), b.double())
    plain_tf32 = torch.einsum("bqd,bsd->bqs", mac._tf32(a), mac._tf32(b))
    exact = torch.einsum("bqd,bsd->bqs", a, b)
    # as good as a float32 product (sums of 32 products of magnitude ~1 up to 20)
    assert (got.double() - want).abs().max().item() <= 2 * (exact.double() - want).abs().max().item()
    assert (plain_tf32.double() - want).abs().max().item() >= 1e-3  # why 3xTF32


@pytest.mark.parametrize("S,chunks", [(850, 14), (3400, 27), (13600, 31), (1, 1), (64, 1), (65, 2)])
def test_chunk_size_for_the_decoder_on_132_sms(S, chunks):
    chunk = mac._chunk_size(S, 8, 132)  # 8 heads, one block of queries
    assert chunk % mac.KEY_TILE == 0 and chunk > 0
    assert -(-S // chunk) == chunks


def test_tiled_refuses_a_chunk_that_is_no_multiple_of_a_tile():
    q, k, v, mask = _inputs(9, 1, 3, 70, per_head=False)
    with pytest.raises(ValueError, match="multiple of 64"):
        _tiled(q, k, v, mask, chunk=100)
