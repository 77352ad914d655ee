"""K2's plain version against the JAX package's tap weighting.

`weight_taps_plain` is held against `weight_taps_reference` and against the
Pallas kernel body itself, run on the CPU in interpret mode as
tests/test_tap_weighting_kernel.py runs it (the monkeypatches live in this
test; the JAX package is untouched). The CUDA kernel is compared with the
plain version in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import mp_former_tpu.ops.tap_weighting as jtw

from mp_former_tpu_torch.ops import tap_weighting as tw

torch.set_num_threads(2)

TOL = 1e-5   # float32 on both sides: summation order only
# bfloat16: products and the P*T-term sum are rounded to 8 bits of mantissa at
# other places in the two frameworks; outputs reach ~P*T/4 (tests/
# test_tap_weighting_kernel.py allows the same)
TOL_BF16 = 5e-2

# (b, q, n_points, n_heads, d): the shapes of tests/test_tap_weighting_kernel.py
SHAPES = [
    (1, 64, 4, 8, 32),    # head-shared, one image
    (8, 64, 4, 1, 32),    # per-head patch tables as the batch
    (8, 96, 12, 1, 32),   # levels concatenated along the points
    (2, 100, 4, 1, 32),   # q not a multiple of any block
    (8, 128, 4, 1, 32),
]


def _inputs(seed, b, q, n_points, n_heads, d, n_taps=4):
    rng = np.random.RandomState(seed)
    taps = rng.rand(b, n_points * q, n_taps * n_heads * d).astype(np.float32)
    w = rng.rand(b, n_points * q, n_taps * n_heads).astype(np.float32)
    return taps, w


def _port(taps, w, n_points, n_heads, d, dtype=torch.float32):
    out = tw.weight_taps(torch.from_numpy(taps).to(dtype), torch.from_numpy(w).to(dtype),
                         n_points, n_heads, d)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX `weight_taps` through its Pallas kernel in interpret mode."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jtw.pl, "pallas_call", patched)
    monkeypatch.setattr(jtw.jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("b,q,n_points,n_heads,d", SHAPES)
def test_plain_matches_jax_reference(b, q, n_points, n_heads, d):
    taps, w = _inputs(0, b, q, n_points, n_heads, d)
    want = np.asarray(jtw.weight_taps_reference(jnp.asarray(taps), jnp.asarray(w),
                                                n_points, n_heads, d))
    got = _port(taps, w, n_points, n_heads, d)
    assert got.shape == want.shape == (b, q, n_heads * d)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("b,q,n_points,n_heads,d", SHAPES)
def test_plain_matches_pallas_kernel_interpret(pallas_interpret, b, q, n_points, n_heads, d):
    taps, w = _inputs(1, b, q, n_points, n_heads, d)
    want = np.asarray(jtw.weight_taps(jnp.asarray(taps), jnp.asarray(w), n_points, n_heads, d))
    np.testing.assert_allclose(_port(taps, w, n_points, n_heads, d), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("kernel", [False, True])
def test_plain_bfloat16_matches_jax(kernel, request):
    if kernel:
        request.getfixturevalue("pallas_interpret")
    b, q, n_points, n_heads, d = 4, 64, 4, 1, 32
    taps, w = _inputs(2, b, q, n_points, n_heads, d)
    fn = jtw.weight_taps if kernel else jtw.weight_taps_reference
    want = np.asarray(fn(jnp.asarray(taps, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                         n_points, n_heads, d)).astype(np.float32)
    got = _port(taps, w, n_points, n_heads, d, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_BF16)


@pytest.mark.parametrize("n_heads", [1, 3])
def test_rows_are_point_major(n_heads):
    """P and Q coprime, weights far from uniform: a query-major reading of the
    rows gives another answer. Checked against the definition, term by term."""
    b, q, n_points, d, n_taps = 2, 7, 3, 4, 4
    rng = np.random.RandomState(3)
    taps = rng.randn(b, n_points * q, n_taps * n_heads * d).astype(np.float32)
    w = (rng.rand(b, n_points * q, n_taps * n_heads) ** 4 * 10).astype(np.float32)
    want = np.zeros((b, q, n_heads * d), np.float64)
    for p in range(n_points):
        for t in range(n_taps):
            for m in range(n_heads):
                rows = taps[:, p * q:(p + 1) * q, (t * n_heads + m) * d:(t * n_heads + m + 1) * d]
                want[:, :, m * d:(m + 1) * d] += rows * w[:, p * q:(p + 1) * q, t * n_heads + m, None]
    got = _port(taps, w, n_points, n_heads, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    query_major = tw.weight_taps_plain(
        torch.from_numpy(taps).view(b, q, n_points, -1).transpose(1, 2).reshape(taps.shape),
        torch.from_numpy(w), n_points, n_heads, d).numpy()
    assert np.abs(query_major - want).max() > 1e-1


def test_cpu_tensors_take_the_plain_version():
    taps, w = _inputs(4, 2, 5, 3, 2, 8)
    before = tw.LAUNCHES
    got = _port(taps, w, 3, 2, 8)
    want = tw.weight_taps_plain(torch.from_numpy(taps), torch.from_numpy(w), 3, 2, 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert tw.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tw.tap_weight_fwd(torch.from_numpy(taps), torch.from_numpy(w), 3, 2, 8)


@pytest.mark.parametrize("n_points,n_heads,d,w_cols,match", [
    (4, 2, 8, 8, "not \\(B, P\\*Q, T\\*M\\*D\\)"),   # 15 rows are not 4 points of anything
    (3, 5, 8, 8, "not \\(B, P\\*Q, T\\*M\\*D\\)"),   # 64 lanes are not a multiple of 5 * 8
    (3, 2, 8, 7, "w .* is not"),                    # w lanes are not T * M
])
def test_wrong_shapes_raise(n_points, n_heads, d, w_cols, match):
    taps = torch.zeros(2, 15, 64)
    w = torch.zeros(2, 15, w_cols)
    with pytest.raises(ValueError, match=match):
        tw.weight_taps(taps, w, n_points, n_heads, d)
