"""The port's video model against the JAX package's, at a small size: the
temporal position term, the temporal decoder alone on a batch of two clips,
`VideoMaskFormer` on a 3-frame clip (weights carried by
`state_dict_from_jax_params`, strict), the converter round trip with the
video decoder's `query_embed`, and all 12 YouTube-VIS recipes built in the
port with the JAX model's parameter shapes (`check_recipe_shapes`, run by
tests/test_torch_video_recipes_{small,large}.py). The JAX package runs its
unpadded forward (no `frame_valid`), which the port's whole-clip forward is.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mp_former_tpu.video  # noqa: F401  (registers the JAX video model)
from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  add_maskformer2_video_config as jax_add_video,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.engine.checkpoint_import import convert_maskformer_state_dict
from mp_former_tpu.models import build_model as jax_build_model
from mp_former_tpu.video.video_decoder import _temporal_pos as jax_temporal_pos

from mp_former_tpu_torch.config import (add_deeplab_config, add_maskformer2_config,
                                        add_maskformer2_video_config, get_cfg)
from mp_former_tpu_torch.engine.convert import (load_state_dict_file, load_weights,
                                                state_dict_from_jax_params)
from mp_former_tpu_torch.models import build_model
from mp_former_tpu_torch.models.transformer_decoder.video_decoder import _temporal_pos

from test_torch_slice import _perturb

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
R50 = "youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml"
# the R50 recipe cut to a CPU test, as tests/test_torch_slice.py cuts the
# image recipe: narrow stages, C=32, 2 encoder and 3 decoder layers, 8 queries
SMALL = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32", "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
    "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "2",
    "MODEL.MASK_FORMER.HIDDEN_DIM", "32", "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
    "MODEL.MASK_FORMER.DEC_LAYERS", "4", "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "8",
    "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96", "MODEL.WEIGHTS", "",
]


def video_cfgs(rel=R50, overrides=SMALL, frames=3):
    """The recipe `rel` with `overrides` in both packages: (JAX cfg, port cfg)."""
    out = []
    for get, adds in ((jax_get_cfg, (jax_add_deeplab, jax_add_mf2, jax_add_video)),
                      (get_cfg, (add_deeplab_config, add_maskformer2_config,
                                 add_maskformer2_video_config))):
        cfg = get()
        for add in adds:
            add(cfg)
        cfg.merge_from_file(os.path.join(CONFIGS, rel))
        cfg.merge_from_list(list(overrides) + ["INPUT.SAMPLING_FRAME_NUM", str(frames)])
        out.append(cfg)
    return tuple(out)


def _at_init(params, start, parts, path=""):
    """`params` with each leaf whose path holds one of `parts` back at `start`."""
    if isinstance(params, dict):
        return {k: _at_init(v, start[k], parts, f"{path}/{k}") for k, v in params.items()}
    return start if any(part in path for part in parts) else params


def build_video_pair(frames=3, seed=0, overrides=SMALL, at_init=()):
    """The JAX model at `frames` frames and the port's, holding the same
    seeded, perturbed weights (the port's init carried into the JAX layout by
    the JAX importer, as `test_torch_slice._build_pair` does), apart from the
    parameters whose path holds one of `at_init`, which keep the init."""
    jcfg, tcfg = video_cfgs(overrides=overrides, frames=frames)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tmodel = build_model(tcfg)
    start = convert_maskformer_state_dict({k: v.numpy() for k, v in tmodel.state_dict().items()})
    params = _at_init(_perturb(start, np.random.RandomState(seed)), start, at_init)
    load_weights(tmodel, state_dict_from_jax_params(params))
    return jcfg, jax_build_model(jcfg), params, tcfg, tmodel


def _hold(got, want, cls_tol=1e-3, mask_tol=1e-2):
    """The image slice's limits (tests/test_torch_slice.py:107-108)."""
    got_cls, got_mask = got["pred_logits"].numpy(), got["pred_masks"].numpy()
    want_cls, want_mask = np.asarray(want["pred_logits"]), np.asarray(want["pred_masks"])
    assert got_mask.shape == want_mask.shape
    assert np.abs(got_cls - want_cls).max() < cls_tol
    assert np.abs(got_mask - want_mask).max() < mask_tol
    near0 = np.abs(want_mask) < 5e-2
    assert (((got_mask > 0) == (want_mask > 0)) | near0).all()


@pytest.mark.parametrize("b,t,c", [(1, 1, 32), (2, 3, 32), (1, 36, 256)])
def test_temporal_pos_matches_jax(b, t, c):
    want = np.asarray(jax_temporal_pos(None, b, t, c, jnp.float32))
    valid = np.asarray(jax_temporal_pos(jnp.ones((b, t), bool), b, t, c, jnp.float32))
    got = _temporal_pos(b, t, c).numpy()
    assert got.shape == want.shape == (b, t, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(want, valid)


def test_video_decoder_matches_jax():
    """The temporal decoder alone, on two clips of 3 frames: seeded
    multi-scale maps and mask features into both decoders, every layer's
    class and mask logits held."""
    from mp_former_tpu.models.transformer_decoder.mask2former_decoder import \
        build_transformer_decoder as jax_build

    from mp_former_tpu_torch.models.transformer_decoder.mask2former_decoder import \
        build_transformer_decoder

    _, jmodel, params, tcfg, tmodel = build_video_pair(frames=3, seed=1)
    jcfg, _ = video_cfgs(frames=3)
    jdec = jax_build(jcfg, 32)
    tdec = tmodel.sem_seg_head.predictor
    assert type(tdec) is type(build_transformer_decoder(tcfg, 32))
    assert tdec.query_embed.weight.shape == (8, 32)
    rng = np.random.RandomState(2)
    b, t = 2, 3
    sizes = [(2, 3), (4, 6), (8, 12)]
    xs = [rng.randn(b * t, h, w, 32).astype(np.float32) for h, w in sizes]
    mf = rng.randn(b * t, 16, 24, 32).astype(np.float32)
    pp = {"params": params["sem_seg_head"]["predictor"]}
    want = jax.jit(lambda p, x, m: jdec.apply(p, x, m))(pp, [jnp.asarray(x) for x in xs],
                                                      jnp.asarray(mf))
    with torch.no_grad():
        got = tdec([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs],
                   torch.from_numpy(mf).permute(0, 3, 1, 2), num_frames=t)
    assert got["pred_masks"].shape == (b, 8, t, 16, 24)
    _hold(got, want)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 3
    for g, w in zip(got["aux_outputs"], want["aux_outputs"]):
        _hold(g, w)
    with pytest.raises(ValueError, match="whole clips"):
        tdec([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs],
             torch.from_numpy(mf).permute(0, 3, 1, 2), num_frames=4)


def test_video_maskformer_matches_jax():
    """A 3-frame clip of raw pixels through both models, the JAX package's
    unpadded forward; the port takes the clip's length from its frames, so a
    model built for SAMPLING_FRAME_NUM 2 serves it the same; with targets
    (and DN groups, which the video model has none of) it returns the same
    outputs, for the losses."""
    jcfg, jmodel, params, tcfg, tmodel = build_video_pair(frames=3)
    clip = (np.random.RandomState(3).rand(1, 3, 64, 96, 3) * 255).astype(np.float32)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, None, train=False))(
        params, jnp.asarray(clip))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(clip))
        assert got["pred_logits"].shape == (1, 8, 41)
        assert got["pred_masks"].shape == (1, 8, 3, 16, 24)
        _hold(got, want)
        for g, w in zip(got["aux_outputs"], want["aux_outputs"]):
            _hold(g, w)
        _, tcfg2 = video_cfgs(frames=2)
        other = build_model(tcfg2)
        other.load_state_dict(tmodel.state_dict())
        again = other(torch.from_numpy(clip))
    torch.testing.assert_close(again["pred_masks"], got["pred_masks"], rtol=0, atol=0)
    train = tmodel(torch.from_numpy(clip), targets=object(), dn_groups=(2, 3))
    assert train.keys() == got.keys() and train["pred_masks"].requires_grad
    torch.testing.assert_close(train["pred_masks"].detach(), got["pred_masks"])


def test_state_dict_round_trip_with_query_embed(tmp_path):
    """The port's state dict through the JAX importer gives the JAX params
    leaf for leaf, `query_embed` among them; a reference-format video
    checkpoint (d2 `model`, the criterion's buffer) loads with strict names."""
    _, _, params, tcfg, tmodel = build_video_pair(frames=3)
    assert "query_embed" in params["sem_seg_head"]["predictor"]
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert "sem_seg_head.predictor.query_embed.weight" in sd
    back = convert_maskformer_state_dict(sd)
    flat_want = {str(k): v for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    flat_got = {str(k): v for k, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)
    ref = {k: v.clone() for k, v in tmodel.state_dict().items()}
    ref["criterion.empty_weight"] = torch.ones(41)
    path = tmp_path / "model_final.pth"
    torch.save({"model": ref, "iteration": 6000}, path)
    fresh = build_model(tcfg)
    load_weights(fresh, load_state_dict_file(str(path)), strict=True)
    for k, v in tmodel.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0, msg=k)


RECIPES = sorted(os.path.relpath(os.path.join(root, f), CONFIGS)
                 for year in ("youtubevis_2019", "youtubevis_2021")
                 for root, _, files in os.walk(os.path.join(CONFIGS, year))
                 for f in files if f.startswith("video_maskformer2"))
_JAX_SHAPES = {}


def check_recipe_shapes(rel):
    """A YouTube-VIS recipe at full width: the port's model on the meta
    device, through the JAX importer, against `jax.eval_shape` of the JAX
    model's init, leaf for leaf (one JAX trace a distinct architecture in a
    process: the 2019 and 2021 recipes differ only in their datasets). The
    tests are tests/test_torch_video_recipes_{small,large}.py."""
    jcfg, tcfg = video_cfgs(rel, overrides=["MODEL.WEIGHTS", ""], frames=2)
    assert tcfg.MODEL.META_ARCHITECTURE == "VideoMaskFormer"
    with torch.device("meta"):
        model = build_model(tcfg)
    assert type(model.sem_seg_head.predictor).__name__ == "VideoMultiScaleMaskedTransformerDecoder"
    zeros = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
             for k, v in model.state_dict().items()}
    got = convert_maskformer_state_dict(zeros)
    key = tcfg.MODEL.dump()
    if key not in _JAX_SHAPES:
        jmodel = jax_build_model(jcfg)
        _JAX_SHAPES[key] = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3)), None, train=False))["params"]
    flat_want = {str(k): v.shape for k, v in
                 jax.tree_util.tree_flatten_with_path(_JAX_SHAPES[key])[0]}
    flat_got = {str(k): np.shape(v) for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_got == flat_want, rel
    n_queries = tcfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES
    assert model.sem_seg_head.predictor.query_embed.weight.shape == (n_queries, 256)
    assert len(RECIPES) == 12
