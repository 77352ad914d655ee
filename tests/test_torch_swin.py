"""The Swin backbone family (`D2SwinTransformer`,
`mp_former_tpu_torch/models/backbone/swin.py`) against the JAX package's
(`mp_former_tpu/models/backbone/swin.py`), on the CPU at tiny widths.

- The backbone: embed 16, depths 2-2-2-2 (every stage has a shifted block),
  window 4, an image whose grid (18x26, 9x13, 5x7, 3x4) is no multiple of the
  window at any stage and odd where two stages merge; APE off and on (the
  pretraining grid, 56x56, shrinks to 18x26 through the cubic resize).
  res2..res5 within 1e-4 of the largest entry (tests/test_swin.py:179 holds
  the JAX Swin to the reference at that tolerance).
- `USE_CHECKPOINT` gives the gradients the module gives without it; drop path
  fires only when `train` is passed, and `MaskFormer` does not pass it.
- Conversion: the JAX Swin's own params through `state_dict_from_jax_params`
  load strictly; official and d2 layouts of Swin files load through
  `load_state_dict_file`, and a wrong index or window raises.
- Every full-width Swin setting of the recipes, built on the meta device, has
  the JAX backbone's parameter shapes through the JAX importer.
- The Swin-L COCO instance recipe at tiny widths against JAX: inference
  (logits within 1e-3, mask logits within 1e-2, tests/test_torch_slice.py)
  and one training step (losses within 1e-4 relative, each gradient within
  1e-3 of its parameter's largest entry, tests/test_torch_train_step.py);
  in bfloat16 within the JAX package's own bfloat16 error
  (tests/test_torch_bf16.py's rule).
"""

import os
import pickle
from unittest import mock

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mp_former_tpu.engine.checkpoint_import import convert_maskformer_state_dict
from mp_former_tpu.engine.convert import swin_params_from_torch
from mp_former_tpu.models.backbone.swin import SwinTransformer as JaxSwin
from mp_former_tpu.models.backbone.swin import build_swin_backbone as jax_build_swin
from mp_former_tpu.models import build_model as jax_build_model
from mp_former_tpu.models.criterion import build_criterion as jax_build_criterion
from mp_former_tpu.models.matcher import _lsa_host

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.engine.convert import (load_state_dict_file, load_weights,
                                                named_gradients_from_jax,
                                                state_dict_from_jax_params)
from mp_former_tpu_torch.models.backbone.swin import (SwinTransformer, build_swin_backbone,
                                                      cubic_resize_weights,
                                                      _relative_position_index)
from mp_former_tpu_torch.models.criterion import build_criterion

from test_torch_bf16 import BF16, _hold_to_jax_bf16, _jax_cfg, _jax_eval, _port_model
from test_torch_dn_decoder import make_targets
from test_torch_segm_recipes import VANILLA
from test_torch_slice import _build_pair

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
SWIN_L = "configs/coco/instance-segmentation/swin/maskformer2_swin_large_IN21k_384_bs16_100ep.yaml"
TINY = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 4, 4, 8), window_size=4)
TINY_CFG = ["MODEL.SWIN.EMBED_DIM", "16", "MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]",
            "MODEL.SWIN.NUM_HEADS", "[2, 4, 4, 8]", "MODEL.SWIN.WINDOW_SIZE", "4"]
# the recipe's own decoder at tests/test_torch_slice.py's widths; nothing drawn
RECIPE = VANILLA + TINY_CFG + [
    "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256", "MODEL.MASK_FORMER.IMPORTANCE_SAMPLE_RATIO",
    "1.0", "MODEL.MASK_FORMER.DROPOUT", "0.0"]
IMG = (64, 96)
BACKBONE_IMG = (72, 104)


def _perturbed(model, seed=0):
    """Seeded noise on every entry, so no part sits at its init."""
    rng = np.random.RandomState(seed)
    sd = {k: v + torch.from_numpy(rng.normal(0, 0.02, v.shape).astype(np.float32))
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    return model


def _official_file(sd, window):
    """The port's backbone state dict laid out as an official Swin
    classification checkpoint: the stored index of every block, the shifted
    blocks' attention masks, a classification head and a final norm, and no
    per-stage output norms."""
    out = {k: v.clone() for k, v in sd.items() if not k.startswith("norm")}
    index = torch.from_numpy(_relative_position_index(window, window))
    for k in sd:
        if k.endswith("attn.relative_position_bias_table"):
            out[k.replace("bias_table", "index")] = index.clone()
            if int(k.split(".")[3]) % 2:
                out[k.replace("attn.relative_position_bias_table", "attn_mask")] = torch.zeros(
                    4, window * window, window * window)
    out.update({"norm.weight": torch.ones(128), "norm.bias": torch.zeros(128),
                "head.weight": torch.zeros(1000, 128), "head.bias": torch.zeros(1000)})
    return out


def test_backbone_matches_jax():
    x = np.random.RandomState(1).randn(2, *BACKBONE_IMG, 3).astype(np.float32)
    shapes = {"res2": (18, 26), "res3": (9, 13), "res4": (5, 7), "res5": (3, 4)}
    for ape in (False, True):
        torch.manual_seed(0)
        model = _perturbed(SwinTransformer(**TINY, ape=ape)).eval()
        params = swin_params_from_torch({k: v.numpy() for k, v in model.state_dict().items()})
        want = jax.jit(lambda p, x: JaxSwin(**TINY, ape=ape).apply({"params": p}, x))(
            params, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert set(got) == set(want) == set(shapes)
        for k, hw in shapes.items():
            w = np.asarray(want[k])
            g = got[k].permute(0, 2, 3, 1).numpy()
            assert g.shape == w.shape == (2, *hw, 16 * 2 ** (int(k[3:]) - 2)), (ape, k)
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (ape, k)
    # the resize alone against jax.image.resize, growing and shrinking
    for n_in, n_out in ((6, 16), (56, 18), (56, 200), (7, 7)):
        a = np.random.RandomState(n_in).randn(1, n_in, 3).astype(np.float32)
        want_r = np.asarray(jax.image.resize(a, (1, n_out, 3), "cubic"))
        got_r = np.einsum("nic,io->noc", a, cubic_resize_weights(n_in, n_out))
        assert np.abs(got_r - want_r).max() <= 1e-4 * np.abs(want_r).max(), (n_in, n_out)


def test_block_recompute_and_drop_path():
    torch.manual_seed(0)
    model = _perturbed(SwinTransformer(**TINY, drop_path_rate=0.3))
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, *BACKBONE_IMG).astype(np.float32))
    weights = {k: torch.randn(v.shape) for k, v in model(x).items()}

    def gradients(use_checkpoint, train=False):
        model.use_checkpoint = use_checkpoint
        model.zero_grad(set_to_none=True)
        out = model(x, train=train, generator=torch.Generator().manual_seed(3))
        sum((out[k] * w).sum() for k, w in weights.items()).backward()
        return out, {n: p.grad.clone() for n, p in model.named_parameters()}

    for train in (False, True):
        out, plain = gradients(False, train)
        out_ckpt, recomputed = gradients(True, train)
        for k in out:
            torch.testing.assert_close(out_ckpt[k], out[k], rtol=0, atol=0)
        for n, g in plain.items():
            torch.testing.assert_close(recomputed[n], g, rtol=0, atol=1e-6 * g.abs().max().item(),
                                       msg=n)
    # drop path: off unless `train`; on, a draw of whole samples from the generator
    with torch.no_grad():
        off = model(x)
        on = model(x, train=True, generator=torch.Generator().manual_seed(3))
        again = model(x, train=True, generator=torch.Generator().manual_seed(3))
        rate0 = SwinTransformer(**TINY, drop_path_rate=0.0)
        rate0.load_state_dict(model.state_dict())
        torch.testing.assert_close(rate0(x, train=True)["res5"], off["res5"], rtol=0, atol=0)
    assert all(torch.equal(on[k], again[k]) for k in on)
    assert not torch.allclose(on["res5"], off["res5"])


def test_conversion_and_swin_files(tmp_path):
    """The JAX Swin's own params (its init, APE on) load strictly through
    `state_dict_from_jax_params`; an official classification file (`.pth`),
    its d2 conversion (`.pkl`) and a reference `model_final.pth` load through
    `load_state_dict_file`; a stored index that is not the computed one, and
    weights of another window, raise."""
    x = jnp.zeros((1, 64, 64, 3))
    params = jax.jit(lambda k: JaxSwin(**TINY, ape=True).init(k, x))(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params["params"])
    sd = state_dict_from_jax_params({"backbone": params})
    model = SwinTransformer(**TINY, ape=True)
    model.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    assert model.absolute_pos_embed.shape == (1, 16, 56, 56)
    back = swin_params_from_torch({k: v.numpy() for k, v in model.state_dict().items()})
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = {str(k): v for k, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert set(flat_back) == set(map(str, flat_want))
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_back[str(k)], v, err_msg=str(k))

    model = SwinTransformer(**TINY)
    own = model.state_dict()
    holder = nn.Module()
    holder.backbone = SwinTransformer(**TINY)
    official = _official_file(own, 4)
    torch.save({"model": official}, tmp_path / "swin_official.pth")
    with open(tmp_path / "swin_official.pkl", "wb") as f:
        pickle.dump({"model": {k: v.numpy() for k, v in official.items()},
                     "__author__": "third_party", "matching_heuristics": True}, f)
    for name in ("swin_official.pth", "swin_official.pkl"):
        got = load_state_dict_file(str(tmp_path / name))
        assert set(got) == {f"backbone.{k}" for k in own if not k.startswith("norm")}, name
        counts = load_weights(holder, got, strict=False)
        assert counts == {"loaded": len(got), "missing": 8, "unexpected": 0, "mismatched": 0}
        for k, v in got.items():
            torch.testing.assert_close(v, own[k[len("backbone."):]], rtol=0, atol=0)
    final = {f"backbone.{k}": v for k, v in official.items()
             if "attn_mask" not in k and not k.startswith(("head.", "norm."))}
    final.update({f"backbone.{k}": v for k, v in own.items() if k.startswith("norm")})
    torch.save({"model": final, "iteration": 3}, tmp_path / "model_final.pth")
    load_weights(holder, load_state_dict_file(str(tmp_path / "model_final.pth")), strict=True)

    key = "backbone.layers.1.blocks.0.attn.relative_position_index"
    final[key] = final[key].flip(0)
    torch.save({"model": final}, tmp_path / "wrong_index.pth")
    with pytest.raises(ValueError, match="relative-position index"):
        load_state_dict_file(str(tmp_path / "wrong_index.pth"))
    other = {f"backbone.{k}": v for k, v in SwinTransformer(**{**TINY, "window_size": 3})
             .state_dict().items()}
    with pytest.raises(ValueError, match="WINDOW_SIZE"):
        load_weights(holder, other, strict=False)


def _recipe_cfg(rel, overrides=()):
    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(os.path.join(CONFIGS, rel))
    cfg.merge_from_list(list(overrides))
    return cfg


def test_full_width_settings_match_jax_in_shape():
    """Each distinct MODEL.SWIN of the 41 image recipes (T, S, B, L), and Swin-L with APE on, where the recipe's PRETRAIN_IMG_SIZE
    of 384 is read by neither package (a 56x56 grid): the port's backbone on
    the meta device, through the JAX importer, against `jax.eval_shape` of the
    JAX backbone's init, leaf for leaf."""
    settings = {}
    for d in ("coco", "ade20k", "cityscapes", "mapillary-vistas"):
        for task in os.listdir(os.path.join(CONFIGS, d)):
            folder = os.path.join(CONFIGS, d, task, "swin")
            for name in sorted(os.listdir(folder)) if os.path.isdir(folder) else ():
                s = _recipe_cfg(os.path.join(d, task, "swin", name)).MODEL.SWIN
                key = (s.EMBED_DIM, tuple(s.DEPTHS), tuple(s.NUM_HEADS), s.WINDOW_SIZE)
                settings.setdefault(key, os.path.join(d, task, "swin", name))
    assert sorted(settings) == [
        (96, (2, 2, 6, 2), (3, 6, 12, 24), 7), (96, (2, 2, 18, 2), (3, 6, 12, 24), 7),
        (128, (2, 2, 18, 2), (4, 8, 16, 32), 12), (192, (2, 2, 18, 2), (6, 12, 24, 48), 12)]
    cases = [(rel, []) for rel in settings.values()]
    cases.append((os.path.relpath(SWIN_L, "configs"), ["MODEL.SWIN.APE", "True"]))
    for rel, extra in cases:
        tcfg = _recipe_cfg(rel, extra)
        with torch.device("meta"):
            model = build_swin_backbone(tcfg)
        zeros = {f"backbone.{k}": np.broadcast_to(np.float32(0), tuple(v.shape))
                 for k, v in model.state_dict().items()}
        got = convert_maskformer_state_dict(zeros)["backbone"]
        jcfg = _jax_cfg(extra, os.path.join("configs", rel))
        jmodel = jax_build_swin(jcfg)
        want = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 64, 64, 3))))["params"]
        flat_want = {str(k): v.shape for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_got = {str(k): np.shape(v) for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
        assert flat_got == flat_want, rel
        if extra:
            assert model.absolute_pos_embed.shape == (1, 192, 56, 56)


@pytest.fixture(scope="module")
def pair():
    """The JAX and port models with the same weights, the image, and the JAX
    float32 inference outputs (shared by both tests)."""
    jcfg, jmodel, params, tcfg, tmodel, img = _build_pair(RECIPE, IMG, SWIN_L)
    return jcfg, jmodel, params, tcfg, tmodel, img, _jax_eval(jmodel, params, img)


def test_swin_l_recipe_matches_jax(pair):
    """Inference, then one training step of the recipe's own (vanilla)
    decoder: the same assignments (the JAX package's cost pass and host
    solver), nothing drawn; the backbone is called without `train`."""
    jcfg, jmodel, params, tcfg, tmodel, img, want = pair
    assert tcfg.MODEL.BACKBONE.NAME == "D2SwinTransformer" and tcfg.MODEL.SWIN.WINDOW_SIZE == 4
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    assert got["pred_masks"].shape == want["pred_masks"].shape == (1, 8, 16, 24)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 3
    for g, w in [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"])):
        assert np.abs(g["pred_logits"].numpy() - w["pred_logits"]).max() < 1e-3
        assert np.abs(g["pred_masks"].numpy() - w["pred_masks"]).max() < 1e-2
        near0 = np.abs(w["pred_masks"]) < 5e-2
        assert (((g["pred_masks"].numpy() > 0) == (w["pred_masks"] > 0)) | near0).all()

    img = np.concatenate([img, img[:, ::-1]], 0)
    jt, tt = make_targets(n=6, size=IMG[0], counts=(3, 1))
    rngs = {"dropout": jax.random.PRNGKey(2)}
    jcrit, tcrit = jax_build_criterion(jcfg), build_criterion(tcfg)
    rng = jax.random.PRNGKey(3)
    num_masks = jnp.float32(jt.valid.sum())

    def loss_fn(p, assignments):
        """The losses under `assignments`, and the matcher's costs (which do
        not depend on them): one compiled function serves both passes."""
        out = jmodel.apply({"params": p}, jnp.asarray(img), jt, train=True, rngs=rngs)
        losses = jcrit(out, jt, rng, num_masks=num_masks, assignments=assignments)
        return jcrit.weighted_total(losses), (losses, jcrit.layer_costs(out, jt, rng)[0])

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    layers = jcfg.MODEL.MASK_FORMER.DEC_LAYERS
    (_, (_, costs)), _ = step(params, jnp.zeros((layers, 2, 6), jnp.int32))
    l, b, q, n = costs.shape
    assignments = _lsa_host(np.asarray(costs).reshape(l * b, q, n)).reshape(l, b, n)
    (_, (jlosses, _)), jgrads = step(params, jnp.asarray(assignments, jnp.int32))

    calls = []
    backbone_forward = tmodel.backbone.forward

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return backbone_forward(*args, **kwargs)

    with mock.patch.object(tmodel.backbone, "forward", spy):
        out = tmodel(torch.from_numpy(img), tt)
    assert calls == [{}]  # no `train`: drop path stays off, as in JAX maskformer.py:90
    tlosses = tcrit(out, tt, None, num_masks=torch.tensor(float(num_masks)),
                    assignments=torch.from_numpy(assignments.astype(np.int64)))
    tmodel.zero_grad(set_to_none=True)
    tcrit.weighted_total(tlosses).backward()
    assert set(tlosses) == set(jlosses) and len(jlosses) == 24
    for k, v in jlosses.items():
        np.testing.assert_allclose(tlosses[k].item(), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    want = named_gradients_from_jax(jax.tree.map(np.asarray, jgrads), tmodel)
    largest = max(g.abs().max().item() for g in want.values())
    for name, p in tmodel.named_parameters():
        scale = max(want[name].abs().max().item(), 1e-4 * largest)
        assert (p.grad - want[name]).abs().max().item() <= 1e-3 * scale, name
    names = [n for n, _ in tmodel.named_parameters()]
    for part in ("patch_embed.proj", "layers.3.blocks.1.attn.relative_position_bias_table",
                 "layers.2.downsample.reduction", "backbone.norm3", "sampling_offsets",
                 "multihead_attn.in_proj_weight"):
        assert any(part in n for n in names), part
    tmodel.zero_grad(set_to_none=True)


def test_swin_l_recipe_in_bfloat16_within_the_jax_error(pair):
    """`TPU.COMPUTE_DTYPE bfloat16`: the port's bfloat16 forward no further
    from the JAX float32 forward than 2x the JAX bfloat16 forward + 1e-2, for
    every layer's logits and masks."""
    _, _, params, _, _, img, f32 = pair
    jbf16 = jax_build_model(_jax_cfg(RECIPE + BF16, SWIN_L))
    model = _port_model(RECIPE + BF16, params, SWIN_L)
    assert model.backbone.patch_embed.proj.weight.dtype == torch.float32
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    assert got["pred_masks"].dtype == torch.bfloat16
    _hold_to_jax_bf16(got, f32, _jax_eval(jbf16, params, img))

