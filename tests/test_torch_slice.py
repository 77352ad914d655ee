"""The port's slice as a whole against the JAX package, at a small size.

The same seeded weights (JAX `model.init`, perturbed so the deformable
offsets and attention weights are not at their zero init) go through
`state_dict_from_jax_params` into the port with strict loading; the same
image goes through both models (a `slow` case does so at the recipe's full
widths). Also: the converter round trip through the JAX package's own
importer, a reference-format checkpoint through `Predictor`, and `Predictor`
on synthetic images. On the CPU the port runs its kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.engine.checkpoint_import import convert_maskformer_state_dict
from mp_former_tpu.models import build_model as jax_build_model

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.engine.convert import load_weights, state_dict_from_jax_params
from mp_former_tpu_torch.engine.predictor import Predictor
from mp_former_tpu_torch.models import build_model

torch.set_num_threads(2)

CONFIG = "configs/coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml"
# the released recipe cut to a CPU test: R50 depth with narrow stages,
# C=32, 2 encoder layers, 3 decoder layers (DEC_LAYERS 4), 8 queries
SMALL = [
    "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME", "MultiScaleMaskedTransformerDecoderMaskDN",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32", "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
    "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "2",
    "MODEL.MASK_FORMER.HIDDEN_DIM", "32", "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
    "MODEL.MASK_FORMER.DEC_LAYERS", "4", "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "8",
    "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
    "TEST.DETECTIONS_PER_IMAGE", "8",
]
IMG = (64, 96)


def _cfg(get, deeplab, mf2, overrides=SMALL, config=CONFIG):
    cfg = get()
    deeplab(cfg)
    mf2(cfg)
    cfg.merge_from_file(config)
    cfg.merge_from_list(overrides)
    return cfg


def _perturb(tree, rng):
    """Seeded noise on every leaf, so no part of the model sits at an init
    that would hide a layout fault (zero offsets, identity FrozenBN)."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if a.ndim == 1 and a.size and np.all(a == 1.0):  # scales / variances stay positive
        return a + rng.uniform(0.0, 0.2, a.shape).astype(np.float32)
    return a + rng.normal(0.0, 0.02, a.shape).astype(np.float32)


def _build_pair(overrides, img_hw, config=CONFIG):
    """JAX model + seeded perturbed params, and the port's model holding the
    same weights (strict load)."""
    jcfg = _cfg(jax_get_cfg, jax_add_deeplab, jax_add_mf2, overrides, config)
    jmodel = jax_build_model(jcfg)
    rng = np.random.RandomState(0)
    img = (rng.rand(1, *img_hw, 3) * 255).astype(np.float32)
    variables = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(img), None, train=False)
    params = _perturb(jax.tree.map(np.asarray, dict(variables["params"])), rng)
    tcfg = _cfg(get_cfg, add_deeplab_config, add_maskformer2_config, overrides, config)
    tmodel = build_model(tcfg)
    load_weights(tmodel, state_dict_from_jax_params(params))
    return jcfg, jmodel, params, tcfg, tmodel, img


@pytest.fixture(scope="module")
def models():
    return _build_pair(SMALL, IMG)


def _assert_outputs_match(jmodel, params, tmodel, img, queries, layers):
    want = jmodel.apply({"params": params}, jnp.asarray(img), None, train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    want_cls = np.asarray(want["pred_logits"])
    want_mask = np.asarray(want["pred_masks"])
    got_cls = got["pred_logits"].numpy()
    got_mask = got["pred_masks"].numpy()
    assert got_cls.shape == want_cls.shape == (1, queries, 81)
    assert got_mask.shape == want_mask.shape == (1, queries, img.shape[1] // 4, img.shape[2] // 4)
    # float32 on both sides; the tolerances of tests/test_full_model_parity.py
    assert np.abs(got_cls - want_cls).max() < 1e-3
    assert np.abs(got_mask - want_mask).max() < 1e-2
    near0 = np.abs(want_mask) < 5e-2
    assert (((got_mask > 0) == (want_mask > 0)) | near0).all()
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == layers


def test_slice_matches_jax(models):
    _, jmodel, params, _, tmodel, img = models
    _assert_outputs_match(jmodel, params, tmodel, img, queries=8, layers=3)


@pytest.mark.slow
def test_slice_matches_jax_full_width():
    """The released recipe at its own widths and depths (R50, C=256, 6
    encoder and 9 decoder layers, 100 queries) on a 128x128 image."""
    overrides = ["MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME",
                 "MultiScaleMaskedTransformerDecoderMaskDN"]
    _, jmodel, params, _, tmodel, img = _build_pair(overrides, (128, 128))
    _assert_outputs_match(jmodel, params, tmodel, img, queries=100, layers=9)


def test_state_dict_round_trip(models):
    """The port's state dict, through the JAX package's importer of reference
    checkpoints, gives back the JAX params leaf by leaf: the port keeps the
    reference's state-dict names."""
    _, _, params, _, tmodel, _ = models
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    back = convert_maskformer_state_dict(sd)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(str, flat_got)) == set(map(str, flat_want))
    got_by_name = {str(k): v for k, v in flat_got.items()}
    for k, v in flat_want.items():
        np.testing.assert_array_equal(got_by_name[str(k)], v, err_msg=str(k))


def test_predictor_serves_synthetic_images(models):
    _, _, _, tcfg, tmodel, _ = models
    predictor = Predictor(tcfg, model=tmodel, device="cpu")
    rng = np.random.RandomState(1)
    for h, w in [(48, 64), (70, 50)]:
        out = predictor(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))["instances"]
        assert out["masks"].shape == (8, h, w) and out["masks"].dtype == bool
        assert out["scores"].shape == (8,) and np.isfinite(out["scores"]).all()
        assert out["classes"].shape == (8,)
        assert ((out["classes"] >= 0) & (out["classes"] < 80)).all()


def test_reference_checkpoint_loads(models, tmp_path):
    """A detectron2-format checkpoint with the reference's old names
    (`static_query`) and its training-only `criterion.*` buffer loads into
    `Predictor` through MODEL.WEIGHTS with strict names."""
    _, _, _, tcfg, tmodel, _ = models
    sd = {k.replace("query_feat", "static_query"): v.clone()
          for k, v in tmodel.state_dict().items()}
    sd["criterion.empty_weight"] = torch.ones(81)
    path = tmp_path / "model_final.pth"
    torch.save({"model": sd, "iteration": 3}, path)
    cfg = tcfg.clone()
    cfg.merge_from_list(["MODEL.WEIGHTS", str(path)])
    loaded = Predictor(cfg, device="cpu").model.state_dict()
    assert loaded.keys() == tmodel.state_dict().keys()
    for k, v in tmodel.state_dict().items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0, msg=k)
