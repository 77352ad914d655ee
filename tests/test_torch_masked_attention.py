"""K3's plain version and the port's MultiheadAttention against the JAX package.

The JAX Pallas kernel runs as its own tests run it on the CPU
(`masked_attention(..., interpret=True)`, tests/test_fused_masked_attention.py).
The CUDA kernel is compared with the plain version in
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp_former_tpu.models.transformer_decoder.primitives import (
    MultiheadAttention as JaxMultiheadAttention)
from mp_former_tpu.ops.fused_masked_attention import masked_attention as jax_masked_attention

from mp_former_tpu_torch.models.transformer_decoder import primitives
from mp_former_tpu_torch.models.transformer_decoder.primitives import MultiheadAttention
from mp_former_tpu_torch.ops import masked_attention_cuda as mac

torch.set_num_threads(2)

TOL = 1e-5  # float32 on both sides: summation order only


def _qkv(seed, B, H, Q, S, D, full_rows=3):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, n, D).astype(np.float32) for n in (Q, S, S))
    mask = rng.rand(B, Q, S) < 0.7
    mask[:, :full_rows] = True  # every key blocked: uniform over the keys
    return q, k, v, mask


def _port(q, k, v, mask):
    return mac.masked_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()


@pytest.mark.parametrize("shared_mask", [True, False])
def test_plain_matches_pallas_kernel_interpret(shared_mask):
    q, k, v, mask = _qkv(0, 2, 4, 37, 512, 32)
    mask4 = np.broadcast_to(mask[:, None], (2, 4, 37, 512))
    if not shared_mask:
        mask4 = np.random.RandomState(1).rand(*mask4.shape) < 0.5
    want = np.asarray(jax_masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(mask4), block_s=256, interpret=True))
    got = _port(q, k, v, mask if shared_mask else np.ascontiguousarray(mask4))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_fully_masked_rows_are_uniform():
    q, k, v, mask = _qkv(2, 1, 2, 6, 45, 8)
    got = _port(q, k, v, mask)
    np.testing.assert_allclose(got[:, :, :3], np.broadcast_to(v.mean(2, keepdims=True),
                                                              got[:, :, :3].shape),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("S,masked", [(850, True), (77, True), (64, False), (3400, True),
                                      (33, True), (1, True), (77, False)])
def test_module_matches_jax_xla_path(S, masked):
    """MultiheadAttention with the same weights: the port's masked path (K3's
    plain version) and unmasked path against primitives.MultiheadAttention."""
    B, Q, C, H = 2, 10, 64, 8
    torch.manual_seed(0)
    mod = MultiheadAttention(C, H)
    with torch.no_grad():
        mod.in_proj_bias.normal_(0, 0.1)
        mod.out_proj.bias.normal_(0, 0.1)
    w, b = mod.in_proj_weight.detach().numpy(), mod.in_proj_bias.detach().numpy()
    params = {n: {"kernel": w[i * C:(i + 1) * C].T, "bias": b[i * C:(i + 1) * C]}
              for i, n in enumerate(("q_proj", "k_proj", "v_proj"))}
    params["out_proj"] = {"kernel": mod.out_proj.weight.detach().numpy().T,
                          "bias": mod.out_proj.bias.detach().numpy()}
    rng = np.random.RandomState(3)
    query, key, value = (rng.randn(B, n, C).astype(np.float32) for n in (Q, S, S))
    mask = rng.rand(B, Q, S) < 0.8 if masked else None
    if masked:
        mask[:, 0] = True
    jmask = None if mask is None else jnp.asarray(np.broadcast_to(mask[:, None], (B, H, Q, S)))
    want = JaxMultiheadAttention(C, H).apply({"params": params}, jnp.asarray(query),
                                             jnp.asarray(key), jnp.asarray(value), jmask)
    with torch.no_grad():
        got = mod(torch.from_numpy(query), torch.from_numpy(key), torch.from_numpy(value),
                  None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, mask = _qkv(4, 1, 2, 5, 40, 32)
    before = mac.LAUNCHES
    got = _port(q, k, v, mask)
    want = mac.masked_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    np.testing.assert_array_equal(got, want)
    assert mac.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        mac.masked_attn_fwd(*(torch.from_numpy(a) for a in (q, k, v, mask)))


@pytest.mark.parametrize("shared_mask", [True, False])
@pytest.mark.parametrize("B,Q,S", [(2, 10, 77), (1, 100, 850), (3, 1, 1)])
def test_plain_on_transposed_views_equals_the_contiguous_call(B, Q, S, shared_mask):
    """The (B, H, N, D) views of (B, N, H, D) projections, as MultiheadAttention
    hands them over, give what their contiguous copies give."""
    H, D = 4, 32
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(B, n, H, D).astype(np.float32)).transpose(1, 2)
               for n in (Q, S, S))
    mask = torch.from_numpy(rng.rand(*((B, Q, S) if shared_mask else (B, H, Q, S))) < 0.6)
    assert S == 1 or not k.is_contiguous()
    got = mac.masked_attention(q, k, v, mask)
    want = mac.masked_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_module_hands_the_head_views_over_without_a_copy(monkeypatch):
    """The masked path gets q, k and v as strided views of the projections
    (last dimension contiguous, rows of 32 floats); the result equals the one
    from contiguous copies."""
    B, Q, S, C, H = 2, 6, 45, 64, 2
    seen = {}
    real = mac.masked_attention

    def spy(q, k, v, mask):
        seen.update(q=q, k=k, v=v)
        return real(q, k, v, mask)

    monkeypatch.setattr(primitives, "masked_attention", spy)
    torch.manual_seed(1)
    mod = MultiheadAttention(C, H)
    rng = np.random.RandomState(6)
    query, key, value = (torch.from_numpy(rng.randn(B, n, C).astype(np.float32))
                         for n in (Q, S, S))
    mask = torch.from_numpy(rng.rand(B, Q, S) < 0.5)
    with torch.no_grad():
        got = mod(query, key, value, mask)
        for name, n in (("q", Q), ("k", S), ("v", S)):
            t = seen[name]
            assert t.shape == (B, H, n, C // H) and t.stride() == (n * C, C // H, C, 1)
        monkeypatch.setattr(primitives, "masked_attention",
                            lambda q, k, v, m: real(q.contiguous(), k.contiguous(),
                                                    v.contiguous(), m))
        want = mod(query, key, value, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
