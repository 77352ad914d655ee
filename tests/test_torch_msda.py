"""K1's plain version and the port's MSDeformAttn against the JAX package.

The JAX Pallas kernel runs as its own tests run it on the CPU
(`_msda_pallas_impl(..., interpret=True)`, tests/test_msda_pallas.py), with
a smaller query block. The CUDA kernel is compared with the plain version in
tests/test_torch_kernels_gpu.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.ops import msda_pallas
from mp_former_tpu.ops.ms_deform_attn import MSDeformAttn as JaxMSDeformAttn
from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn as jax_ms_deform_attn

from mp_former_tpu_torch.ops import msda_cuda
from mp_former_tpu_torch.ops.ms_deform_attn import MSDeformAttn, ms_deform_attn

torch.set_num_threads(2)

TOL = 1e-5  # float32 on both sides: summation order only


def _inputs(seed, B, Q, M, D, shapes, P, lo=-0.2, hi=1.2):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    # locations partly outside [0, 1]: taps off the map read zero
    loc = rng.uniform(lo, hi, (B, Q, M, len(shapes), P, 2)).astype(np.float32)
    attn = rng.rand(B, Q, M, len(shapes) * P).astype(np.float32) + 1e-3
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(B, Q, M, len(shapes), P)
    return value, loc, attn


def _port(value, shapes, loc, attn):
    return ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                          torch.from_numpy(attn)).numpy()


@pytest.mark.parametrize("seed,B,Q", [(0, 2, 37), (1, 1, 130)])
def test_plain_matches_pallas_kernel_interpret(seed, B, Q, monkeypatch):
    # the kernel body as it is, with 128-query blocks and a rolled point loop:
    # the default 512-query block fully unrolls 256 loop steps, which takes
    # minutes to trace on the CPU; blocking does not change the result
    monkeypatch.setattr(msda_pallas, "_gather_weight_level",
                        functools.partial(msda_pallas._gather_weight_level, qb=128, unroll=8))
    shapes = [(8, 12), (4, 6), (2, 3)]
    value, loc, attn = _inputs(seed, B, Q, 8, 32, shapes, 4)
    want = np.asarray(jax.jit(lambda v, l, a: msda_pallas._msda_pallas_impl(
        v, l, a, shapes, interpret=True))(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn)))
    np.testing.assert_allclose(_port(value, shapes, loc, attn), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shapes,P,D", [
    ([(6, 4), (3, 2)], 2, 2),
    ([(5, 7), (3, 4), (2, 2), (1, 1)], 3, 8),
    ([(16, 16), (8, 8), (4, 4)], 4, 32),
])
def test_plain_matches_xla_engine(shapes, P, D):
    value, loc, attn = _inputs(3, 2, 19, 4, D, shapes, P, lo=-0.5, hi=1.5)
    want = np.asarray(jax.jit(lambda v, l, a: jax_ms_deform_attn(v, shapes, l, a))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn)))
    np.testing.assert_allclose(_port(value, shapes, loc, attn), want, rtol=0, atol=TOL)


def test_all_points_off_the_map_give_zero():
    shapes = [(4, 5), (2, 3)]
    value, loc, attn = _inputs(4, 1, 6, 2, 4, shapes, 2)
    loc = loc + 3.0
    np.testing.assert_array_equal(_port(value, shapes, loc, attn), 0.0)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_module_matches_jax(ref_dim):
    C, L, M, P, Q = 64, 3, 8, 4, 11
    shapes = [(6, 8), (3, 4), (2, 2)]
    S = sum(h * w for h, w in shapes)
    torch.manual_seed(0)
    mod = MSDeformAttn(C, L, M, P)
    rng = np.random.RandomState(5)
    with torch.no_grad():  # move off the zero init of offsets and weights
        for lin in (mod.sampling_offsets, mod.attention_weights):
            lin.weight.copy_(torch.from_numpy(rng.normal(0, 0.05, lin.weight.shape).astype(np.float32)))
    params = {name: {"kernel": getattr(mod, name).weight.detach().numpy().T,
                     "bias": getattr(mod, name).bias.detach().numpy()}
              for name in ("value_proj", "sampling_offsets", "attention_weights", "output_proj")}
    query = rng.randn(2, Q, C).astype(np.float32)
    feats = rng.randn(2, S, C).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (2, Q, L, ref_dim)).astype(np.float32)
    jmod = JaxMSDeformAttn(d_model=C, n_levels=L, n_heads=M, n_points=P)
    want = jax.jit(lambda p, q, r, f: jmod.apply(p, q, r, f, shapes))(
        {"params": params}, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(feats))
    with torch.no_grad():
        got = mod(torch.from_numpy(query), torch.from_numpy(ref), torch.from_numpy(feats), shapes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_offset_bias_is_the_compass_rose():
    jmod = JaxMSDeformAttn(d_model=256, n_levels=3, n_heads=8, n_points=4)
    want = np.asarray(jmod._offset_bias_init(None, None))
    np.testing.assert_allclose(MSDeformAttn(256, 3, 8, 4).sampling_offsets.bias.detach().numpy(),
                               want, rtol=0, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    shapes = [(4, 4), (2, 2)]
    value, loc, attn = _inputs(6, 1, 5, 2, 32, shapes, 2)
    before = msda_cuda.LAUNCHES
    got = _port(value, shapes, loc, attn)
    want = msda_cuda.ms_deform_attn_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                          torch.from_numpy(attn)).numpy()
    np.testing.assert_array_equal(got, want)
    assert msda_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_fwd(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                           torch.from_numpy(attn))
