"""The head-shared sampling engine and the tap-weighting route of the per-head
engine against the JAX package: the functions, the `MSDeformAttn` module and
the whole model of the TPU recipe (`..._DN_query_tpu.yaml`, in float32) at a
small size, with weights carried by `state_dict_from_jax_params`. Sampling
locations reach outside [0, 1] in every functional test. On the CPU the port
runs K2's plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.ops.ms_deform_attn import MSDeformAttn as JaxMSDeformAttn
from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn as jax_ms_deform_attn
from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn_headshare as jax_headshare

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.engine.convert import load_weights
from mp_former_tpu_torch.models import build_model
from mp_former_tpu_torch.ops import tap_weighting
from mp_former_tpu_torch.ops.ms_deform_attn import (MSDeformAttn, ms_deform_attn,
                                                    ms_deform_attn_headshare)

from test_torch_slice import SMALL, IMG, _assert_outputs_match, _build_pair, _cfg

torch.set_num_threads(2)

TOL = 1e-5  # float32 on both sides: summation order only
TPU_CONFIG = "configs/coco/instance-segmentation/maskformer2_R50_bs16_50ep_DN_query_tpu.yaml"
# the recipe asks for bfloat16 compute; the slice runs it in float32
FLOAT32 = ["TPU.COMPUTE_DTYPE", "float32"]

SHAPE_CASES = [
    ([(6, 4), (3, 2)], 2, 2, 4),
    ([(5, 7), (3, 4), (2, 2), (1, 1)], 3, 8, 3),
    ([(16, 16), (8, 8), (4, 4)], 4, 32, 8),
]


def _inputs(seed, B, Q, M, D, shapes, P, shared):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc_shape = (B, Q, L, P, 2) if shared else (B, Q, M, L, P, 2)
    loc = rng.uniform(-0.5, 1.5, loc_shape).astype(np.float32)  # partly off the map
    attn = rng.rand(B, Q, M, L * P).astype(np.float32) ** 3 + 1e-3
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(B, Q, M, L, P)
    return value, loc, attn


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("pallas_weighting", [False, True])
@pytest.mark.parametrize("shapes,P,D,M", SHAPE_CASES)
def test_headshare_matches_jax(shapes, P, D, M, pallas_weighting):
    value, loc, attn = _inputs(0, 2, 19, M, D, shapes, P, shared=True)
    want = np.asarray(jax.jit(lambda v, l, a: jax_headshare(
        v, shapes, l, a, pallas_weighting=pallas_weighting))(
            jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn)))
    launches = tap_weighting.LAUNCHES
    got = ms_deform_attn_headshare(*_t(value), shapes, *_t(loc, attn),
                                   pallas_weighting=pallas_weighting).numpy()
    assert tap_weighting.LAUNCHES == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shapes,P,D,M", SHAPE_CASES)
def test_tap_weighting_route_matches_jax(shapes, P, D, M):
    value, loc, attn = _inputs(1, 2, 17, M, D, shapes, P, shared=False)
    want = np.asarray(jax.jit(lambda v, l, a: jax_ms_deform_attn(
        v, shapes, l, a, pallas_weighting=True))(
            jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn)))
    got = ms_deform_attn(*_t(value), shapes, *_t(loc, attn), pallas_weighting=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the two routes of the per-head engine are one function
    k1_plain = ms_deform_attn(*_t(value), shapes, *_t(loc, attn)).numpy()
    np.testing.assert_allclose(got, k1_plain, rtol=0, atol=TOL)


@pytest.mark.parametrize("pallas_weighting", [False, True])
def test_headshare_equals_per_head_engine_on_shared_locations(pallas_weighting):
    shapes = [(12, 16), (6, 8), (3, 4)]
    B, Q, M, D, P = 2, 11, 4, 8, 3  # P and Q coprime
    value, loc, attn = _inputs(2, B, Q, M, D, shapes, P, shared=True)
    shared = ms_deform_attn_headshare(*_t(value), shapes, *_t(loc, attn),
                                      pallas_weighting=pallas_weighting).numpy()
    loc_all = np.ascontiguousarray(np.broadcast_to(loc[:, :, None], (B, Q, M, 3, P, 2)))
    per_head = ms_deform_attn(*_t(value), shapes, *_t(loc_all, attn)).numpy()
    np.testing.assert_allclose(shared, per_head, rtol=0, atol=TOL)


def test_points_off_the_map_give_zero():
    shapes = [(4, 5), (2, 3)]
    value, loc, attn = _inputs(3, 1, 6, 2, 4, shapes, 2, shared=True)
    for shift in (3.0, -3.0):
        for pw in (False, True):
            out = ms_deform_attn_headshare(*_t(value), shapes, *_t(loc + shift, attn),
                                           pallas_weighting=pw)
            np.testing.assert_array_equal(out.numpy(), 0.0)
    value, loc, attn = _inputs(3, 1, 6, 2, 4, shapes, 2, shared=False)
    out = ms_deform_attn(*_t(value), shapes, *_t(loc + 3.0, attn), pallas_weighting=True)
    np.testing.assert_array_equal(out.numpy(), 0.0)


def test_bfloat16_rounds_the_weights_as_jax_does():
    """The weights are cast to the taps' type before K2: in bfloat16 both
    packages round them at the same place."""
    shapes = [(8, 8), (4, 4)]
    value, loc, attn = _inputs(4, 1, 13, 4, 8, shapes, 4, shared=True)
    want = np.asarray(jax_headshare(
        jnp.asarray(value, jnp.bfloat16), shapes, jnp.asarray(loc, jnp.bfloat16),
        jnp.asarray(attn, jnp.bfloat16), pallas_weighting=True)).astype(np.float32)
    v, lo, a = (t.to(torch.bfloat16) for t in _t(value, loc, attn))
    got = ms_deform_attn_headshare(v, shapes, lo, a, pallas_weighting=True)
    assert got.dtype == torch.bfloat16
    # outputs of magnitude ~1, rounded to 8 bits of mantissa after each level
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=3e-2)


def _module_pair(engine, pallas_weighting, C=64, L=3, M=8, P=4):
    torch.manual_seed(0)
    mod = MSDeformAttn(C, L, M, P, engine, pallas_weighting)
    rng = np.random.RandomState(5)
    with torch.no_grad():  # move off the zero init of offsets and weights
        for lin in (mod.sampling_offsets, mod.attention_weights):
            lin.weight.copy_(torch.from_numpy(rng.normal(0, 0.05, lin.weight.shape).astype(np.float32)))
    params = {name: {"kernel": getattr(mod, name).weight.detach().numpy().T,
                     "bias": getattr(mod, name).bias.detach().numpy()}
              for name in ("value_proj", "sampling_offsets", "attention_weights", "output_proj")}
    jmod = JaxMSDeformAttn(d_model=C, n_levels=L, n_heads=M, n_points=P, sampling_engine=engine,
                           pallas_weighting=pallas_weighting)
    return mod, jmod, params, rng


@pytest.mark.parametrize("engine,pallas_weighting", [
    ("headshare", False), ("headshare", True), ("packed2x2", True)])
@pytest.mark.parametrize("ref_dim", [2, 4])
def test_module_matches_jax(engine, pallas_weighting, ref_dim):
    C, L, Q = 64, 3, 11
    shapes = [(6, 8), (3, 4), (2, 2)]
    S = sum(h * w for h, w in shapes)
    mod, jmod, params, rng = _module_pair(engine, pallas_weighting)
    assert mod.sampling_offsets.out_features == (1 if engine == "headshare" else 8) * L * 4 * 2
    query = rng.randn(2, Q, C).astype(np.float32)
    feats = rng.randn(2, S, C).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, (2, Q, L, ref_dim)).astype(np.float32)
    want = jax.jit(lambda p, q, r, f: jmod.apply(p, q, r, f, shapes))(
        {"params": params}, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(feats))
    with torch.no_grad():
        got = mod(*_t(query, ref, feats), shapes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_shared_offset_bias_is_the_per_point_compass_rose():
    jmod = JaxMSDeformAttn(d_model=256, n_levels=3, n_heads=8, n_points=4,
                           sampling_engine="headshare")
    want = np.asarray(jmod._offset_bias_init_shared(None, None))
    mod = MSDeformAttn(256, 3, 8, 4, "headshare")
    assert want.shape == (3 * 4 * 2,)
    np.testing.assert_allclose(mod.sampling_offsets.bias.detach().numpy(), want, rtol=0, atol=1e-6)
    assert (mod.sampling_offsets.weight == 0).all()


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="sampling_engine"):
        MSDeformAttn(64, 3, 8, 4, "superrow6")


@pytest.fixture(scope="module")
def tpu_recipe_models():
    """The TPU recipe (head-shared engine, tap weighting) in float32, small."""
    return _build_pair(SMALL + FLOAT32, IMG, TPU_CONFIG)


def test_tpu_recipe_matches_jax(tpu_recipe_models):
    jcfg, jmodel, params, tcfg, tmodel, img = tpu_recipe_models
    assert tcfg.TPU.SAMPLING_ENGINE == "headshare" and tcfg.TPU.PALLAS_TAP_WEIGHTING
    attn = tmodel.sem_seg_head.pixel_decoder.transformer.encoder.layers[0].self_attn
    assert attn.headshare and attn.pallas_weighting
    assert attn.sampling_offsets.out_features == 3 * 4 * 2
    _assert_outputs_match(jmodel, params, tmodel, img, queries=8, layers=3)


def test_per_head_tap_weighting_model_matches_jax():
    """The released recipe with `TPU.PALLAS_TAP_WEIGHTING True`: the per-head
    engine through the patch-table gather and K2's plain version."""
    _, jmodel, params, tcfg, tmodel, img = _build_pair(
        SMALL + ["TPU.PALLAS_TAP_WEIGHTING", "True"], IMG)
    attn = tmodel.sem_seg_head.pixel_decoder.transformer.encoder.layers[0].self_attn
    assert not attn.headshare and attn.pallas_weighting
    _assert_outputs_match(jmodel, params, tmodel, img, queries=8, layers=3)


@pytest.mark.slow
def test_tpu_recipe_matches_jax_full_width():
    """The TPU recipe at its own widths and depths (R50, C=256, 6 encoder and
    9 decoder layers, 100 queries), float32, on a 128x128 image."""
    overrides = ["MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME",
                 "MultiScaleMaskedTransformerDecoderMaskDN"] + FLOAT32
    _, jmodel, params, _, tmodel, img = _build_pair(overrides, (128, 128), TPU_CONFIG)
    _assert_outputs_match(jmodel, params, tmodel, img, queries=100, layers=9)


@pytest.mark.parametrize("weights,model_engine,trained,built", [
    ("headshare", "packed2x2", "trained with head-shared", "built with per-head"),
    ("packed2x2", "headshare", "trained with per-head", "built with head-shared"),
])
def test_weights_of_the_other_engine_are_refused(tpu_recipe_models, weights, model_engine,
                                                 trained, built):
    _, _, _, tcfg, tmodel, _ = tpu_recipe_models
    cfg = _cfg(get_cfg, add_deeplab_config, add_maskformer2_config,
               SMALL + FLOAT32 + ["TPU.SAMPLING_ENGINE", "packed2x2"], TPU_CONFIG)
    per_head_model = build_model(cfg)
    source, target = ((tmodel, per_head_model) if weights == "headshare"
                      else (per_head_model, tmodel))
    with pytest.raises(ValueError, match=f"{trained}.*{built}.*do not interconvert"):
        load_weights(target, source.state_dict())
    load_weights(source, source.state_dict())  # its own kind loads
