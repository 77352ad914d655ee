"""The whole model of the TPU recipe (`..._DN_query_tpu.yaml`, head-shared
engine and tap weighting, in float32) and of the released recipe with
`TPU.PALLAS_TAP_WEIGHTING True` against the JAX package at a small size, the
weights of one engine refused by the other, and K2's bfloat16 rounding
(tests/test_torch_headshare.py holds the functions and the module). Six tests
at most a file: the Tier-1 run queues such files behind its longest one
(ROADMAP.md, "Tier-1's clock").
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp_former_tpu.ops.ms_deform_attn import ms_deform_attn_headshare as jax_headshare

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.engine.convert import load_weights
from mp_former_tpu_torch.models import build_model
from mp_former_tpu_torch.ops.ms_deform_attn import ms_deform_attn_headshare

from test_torch_headshare import FLOAT32, TPU_CONFIG, _inputs, _t
from test_torch_slice import IMG, SMALL, _assert_outputs_match, _build_pair, _cfg

torch.set_num_threads(2)


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
