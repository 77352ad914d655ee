"""The port's LR schedules, parameter groups and AdamW step against the JAX
package's optax chain (`mp_former_tpu/engine/optimizer.py`).

The JAX chain adds `wd * p` after `scale_by_adam` and before the LR: decoupled
decay scaled by the LR, which is `torch.optim.AdamW`'s rule. The test shows it
on the tiny model's full parameter tree with the same gradients on both sides,
carried across by `state_dict_from_jax_params` (a linear map, which the test
also shows). Tolerance: 1e-6 relative on schedule values; parameters after two
steps within 1e-6 absolute (a few float32 ulps of parameters of size ~1, each
moved twice by about LR = 1e-2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mp_former_tpu.engine import optimizer as jopt

from mp_former_tpu_torch.engine import optimizer as topt
from mp_former_tpu_torch.engine.convert import (load_weights, named_gradients_from_jax,
                                                state_dict_from_jax_params)

from test_torch_slice import IMG, SMALL, _build_pair

torch.set_num_threads(2)

SOLVER = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "3", "SOLVER.WARMUP_FACTOR", "0.1",
          "SOLVER.LR_SCHEDULER_NAME", "WarmupMultiStepLR", "SOLVER.STEPS", "(1, 5)",
          "SOLVER.WEIGHT_DECAY", "0.05", "SOLVER.WEIGHT_DECAY_NORM", "0.01",
          "SOLVER.WEIGHT_DECAY_EMBED", "0.02"]


@pytest.fixture(scope="module")
def pair():
    return _build_pair(SMALL + SOLVER + ["MODEL.BACKBONE.FREEZE_AT", "0"], IMG)


def _random_like(tree, rng, scale=1.0):
    return jax.tree.map(lambda a: (rng.randn(*np.shape(a)) * scale).astype(np.float32), tree)


def _zero_frozen_bn(tree):
    """FrozenBN leaves have no counterpart among the port's parameters."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.zeros_like(a) if jopt.is_frozen_param(path) else a, tree)


@pytest.mark.parametrize("name,extra", [
    ("WarmupMultiStepLR", ["SOLVER.STEPS", "(4, 9)", "SOLVER.WARMUP_ITERS", "3",
                           "SOLVER.WARMUP_FACTOR", "0.1"]),
    ("WarmupMultiStepLR", ["SOLVER.WARMUP_FACTOR", "1.0"]),
    ("WarmupPolyLR", ["SOLVER.MAX_ITER", "12", "SOLVER.WARMUP_ITERS", "4"]),
    ("WarmupPolyLR", ["SOLVER.MAX_ITER", "12", "SOLVER.WARMUP_ITERS", "0",
                      "SOLVER.POLY_LR_CONSTANT_ENDING", "0.3"]),
])
def test_lr_schedule_values_match_jax(pair, name, extra):
    jcfg, tcfg = pair[0].clone(), pair[3].clone()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(["SOLVER.LR_SCHEDULER_NAME", name, *extra])
    want, got = jopt.build_lr_schedule(jcfg), topt.build_lr_schedule(tcfg)
    for count in range(15):
        np.testing.assert_allclose(got(count), float(want(jnp.asarray(count))), rtol=1e-6,
                                   err_msg=f"{name} at {count}")
    tcfg.merge_from_list(["SOLVER.LR_SCHEDULER_NAME", "Cosine"])
    with pytest.raises(ValueError, match="Unknown LR scheduler"):
        topt.build_lr_schedule(tcfg)


def test_converter_is_linear_so_it_carries_gradients(pair):
    _, _, params, _, tmodel, _ = pair
    rng = np.random.RandomState(0)
    x, y = _random_like(params, rng), _random_like(params, rng)
    combo = jax.tree.map(lambda a, b: 2.0 * a - 0.5 * b, x, y)
    sd_x, sd_y, sd_c = (state_dict_from_jax_params(t) for t in (x, y, combo))
    assert sd_x.keys() == tmodel.state_dict().keys()
    for k in sd_c:
        torch.testing.assert_close(sd_c[k], 2.0 * sd_x[k] - 0.5 * sd_y[k], rtol=1e-6, atol=1e-6)
    named = named_gradients_from_jax(x, tmodel)
    assert list(named) == [n for n, _ in tmodel.named_parameters()]
    assert all(named[n].shape == p.shape for n, p in tmodel.named_parameters())
    assert not any("running_mean" in n for n in named)


@pytest.mark.parametrize("freeze_at", [0, 2])
def test_group_membership_matches_jax(pair, freeze_at):
    """Weight decay, LR multiplier and frozen stages of every parameter: the
    JAX package's path predicates, written as trees of constants and carried
    through the converter, against the port's parameter groups."""
    jcfg, _, params, tcfg, tmodel, _ = pair
    jcfg, tcfg = jcfg.clone(), tcfg.clone()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(["MODEL.BACKBONE.FREEZE_AT", str(freeze_at)])
    s = jcfg.SOLVER

    def per_leaf(fn):
        return jax.tree_util.tree_map_with_path(
            lambda path, a: np.full(np.shape(a), fn(path), np.float32), params)

    def wd(path):
        return (s.WEIGHT_DECAY_NORM if jopt.is_norm_param(path) else
                s.WEIGHT_DECAY_EMBED if jopt.is_embed_param(path) else s.WEIGHT_DECAY)

    def frozen(path):
        toks = [str(t) for t in jopt._path_tokens(path)]
        if toks[0] != "backbone":
            return 0.0
        stages = ["stem_"] * (freeze_at >= 1) + [f"res{k}_" for k in range(2, freeze_at + 1)]
        return float(toks[1].startswith(tuple(stages))) if stages else 0.0

    want_wd = state_dict_from_jax_params(per_leaf(wd))
    want_mult = state_dict_from_jax_params(per_leaf(
        lambda path: s.BACKBONE_MULTIPLIER if jopt.is_backbone_param(path) else 1.0))
    want_frozen = state_dict_from_jax_params(per_leaf(frozen))

    import copy
    model = copy.deepcopy(tmodel)
    topt.freeze_backbone(model, freeze_at)
    groups = topt.param_groups(tcfg, model)
    seen = {}
    for g in groups:
        assert len(g["params"]) == len(g["names"])
        for n in g["names"]:
            seen[n] = (g["weight_decay"], g["lr"])
    for n, p in model.named_parameters():
        assert p.requires_grad == (want_frozen[n].max().item() == 0.0), n
        if p.requires_grad:
            assert seen[n][0] == pytest.approx(want_wd[n].flatten()[0].item()), n
            assert seen[n][1] == pytest.approx(want_mult[n].flatten()[0].item()), n
        else:
            assert n not in seen
    assert {wd for wd, _ in seen.values()} == {0.05, 0.01, 0.02}
    if freeze_at == 2:
        assert not any(n.startswith(("backbone.stem", "backbone.res2")) for n in seen)
        assert any(n.startswith("backbone.res3") for n in seen)


@pytest.mark.parametrize("clip", [False, True])
def test_two_adamw_steps_match_optax_on_the_same_gradients(pair, clip):
    """Schedule with warm-up and a decay step, per-group decay, the backbone
    multiplier and full-model clipping at 0.01, over two steps (bias correction
    and the schedule move). The FrozenBN leaves get zero gradients on the JAX
    side: they are buffers in the port and outside its clipped norm."""
    jcfg, _, params, tcfg, tmodel, _ = pair
    jcfg, tcfg = jcfg.clone(), tcfg.clone()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(["SOLVER.CLIP_GRADIENTS.ENABLED", str(clip)])
    assert tcfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE == "full_model"
    rng = np.random.RandomState(1)
    grads = [_zero_frozen_bn(_random_like(params, rng, 0.05)) for _ in range(2)]

    tx = jopt.build_optimizer(jcfg, params)

    @jax.jit
    def two_steps(want, grads):
        state = tx.init(want)
        for g in grads:
            updates, state = tx.update(g, state, want)
            want = optax.apply_updates(want, updates)
        return want

    want = two_steps(params, grads)

    import copy
    model = copy.deepcopy(tmodel)
    load_weights(model, state_dict_from_jax_params(params))
    optimizer, scheduler = topt.build_optimizer(tcfg, model)
    clipper = topt.build_gradient_clipper(tcfg)
    assert (clipper is not None) == clip
    lrs = []
    for g in grads:
        named = named_gradients_from_jax(g, model)
        for n, p in model.named_parameters():
            p.grad = named[n].clone()
        if clipper is not None:
            clipper([p for group in optimizer.param_groups for p in group["params"]])
        lrs.append(scheduler.get_last_lr())
        optimizer.step()
        scheduler.step()
    # warm-up from 0.1 x, then the decay step at 1: per-group LR = multiplier x schedule
    sched = jopt.build_lr_schedule(jcfg)
    for step, row in enumerate(lrs):
        for lr, group in zip(row, optimizer.param_groups):
            mult = 0.1 if group["names"][0].startswith("backbone.") else 1.0
            assert lr == pytest.approx(mult * float(sched(step)), rel=1e-6)
    want_sd = state_dict_from_jax_params(jax.tree.map(np.asarray, want))
    start_sd = state_dict_from_jax_params(params)
    moved = 0.0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want_sd[k], rtol=0, atol=1e-6, msg=k)
        moved = max(moved, (v - start_sd[k]).abs().max().item())
    assert moved > 1e-3  # the steps were not no-ops


def test_sgd_and_unknown_optimizers(pair):
    tcfg = pair[3].clone()
    import copy
    model = copy.deepcopy(pair[4])
    tcfg.merge_from_list(["SOLVER.OPTIMIZER", "SGD"])
    optimizer, _ = topt.build_optimizer(tcfg, model)
    assert isinstance(optimizer, torch.optim.SGD)
    tcfg.merge_from_list(["SOLVER.OPTIMIZER", "LION"])
    with pytest.raises(NotImplementedError, match="LION"):
        topt.build_optimizer(tcfg, model)
    tcfg.merge_from_list(["SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                          "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "value"])
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.tensor([-5.0, 0.001, 5.0])
    topt.build_gradient_clipper(tcfg)([p])
    torch.testing.assert_close(p.grad, torch.tensor([-0.01, 0.001, 0.01]))


SWIN_L = "configs/coco/instance-segmentation/swin/maskformer2_swin_large_IN21k_384_bs16_100ep.yaml"
TINY_SWIN = ["MODEL.SWIN.EMBED_DIM", "16", "MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]",
             "MODEL.SWIN.NUM_HEADS", "[2, 4, 4, 8]", "MODEL.SWIN.WINDOW_SIZE", "4",
             "MODEL.SWIN.APE", "True"]


@pytest.mark.parametrize("freeze_at", [0, 1, 3])
def test_swin_group_membership_matches_jax(freeze_at):
    """The Swin's names (ROADMAP's `_EMBED_TOKENS` trap): weight decay by the
    JAX package's `is_norm_param` / `is_embed_param`, the backbone multiplier,
    and FREEZE_AT as the JAX optax chain itself masks it (a leaf whose update
    of all-ones gradients is 0 is frozen; the reference's Swin reads no
    FREEZE_AT): patch and position embeddings from 1, `layers.{s-2}` up to
    stage s, the output norms never."""
    jcfg, _, params, tcfg, tmodel, _ = _build_pair(
        SMALL + SOLVER + TINY_SWIN + ["MODEL.BACKBONE.FREEZE_AT", str(freeze_at)], IMG, SWIN_L)
    s = jcfg.SOLVER
    tx = jopt.build_optimizer(jcfg, params)
    updates, _ = jax.jit(lambda p: tx.update(jax.tree.map(jnp.ones_like, p), tx.init(p), p))(
        params)

    def per_leaf(fn):
        return state_dict_from_jax_params(jax.tree_util.tree_map_with_path(
            lambda path, a: np.full(np.shape(a), fn(path), np.float32), params))

    want_wd = per_leaf(lambda path: s.WEIGHT_DECAY_NORM if jopt.is_norm_param(path) else
                       s.WEIGHT_DECAY_EMBED if jopt.is_embed_param(path) else s.WEIGHT_DECAY)
    want_mult = per_leaf(lambda path: s.BACKBONE_MULTIPLIER if jopt.is_backbone_param(path)
                         else 1.0)
    want_frozen = state_dict_from_jax_params(jax.tree.map(
        lambda u: np.full(np.shape(u), float(np.all(np.asarray(u) == 0)), np.float32), updates))

    import copy
    model = copy.deepcopy(tmodel)
    topt.freeze_backbone(model, freeze_at)
    seen = {n: (g["weight_decay"], g["lr"]) for g in topt.param_groups(tcfg, model)
            for n in g["names"]}
    for n, p in model.named_parameters():
        assert p.requires_grad == (want_frozen[n].max().item() == 0.0), n
        if p.requires_grad:
            assert seen[n] == (pytest.approx(want_wd[n].flatten()[0].item()),
                               pytest.approx(want_mult[n].flatten()[0].item())), n
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    stages = ("backbone.patch_embed.", "backbone.absolute_pos_embed",
              *(f"backbone.layers.{i}." for i in range(max(freeze_at - 1, 0))))
    assert frozen == {n for n in seen.keys() | frozen if freeze_at and n.startswith(stages)}
    assert seen["backbone.layers.3.blocks.1.attn.relative_position_bias_table"][0] == 0.02
    assert seen["backbone.norm3.weight"][0] == 0.01


def test_video_group_membership_matches_jax():
    """The video decoder's names (ROADMAP's `_EMBED_TOKENS` trap): weight
    decay and LR multiplier of every parameter of the YouTube-VIS R50 recipe
    by the JAX package's `is_norm_param` / `is_embed_param` /
    `is_backbone_param`, against the port's groups; `query_embed`, the video
    decoder's own table, decays as an embedding in both."""
    from test_torch_video import SMALL as VIDEO_SMALL, build_video_pair

    jcfg, _, params, tcfg, tmodel = build_video_pair(
        frames=2, overrides=VIDEO_SMALL + SOLVER + ["MODEL.BACKBONE.FREEZE_AT", "0"])
    s = jcfg.SOLVER

    def per_leaf(fn):
        return state_dict_from_jax_params(jax.tree_util.tree_map_with_path(
            lambda path, a: np.full(np.shape(a), fn(path), np.float32), params))

    want_wd = per_leaf(lambda path: s.WEIGHT_DECAY_NORM if jopt.is_norm_param(path) else
                       s.WEIGHT_DECAY_EMBED if jopt.is_embed_param(path) else s.WEIGHT_DECAY)
    want_mult = per_leaf(lambda path: s.BACKBONE_MULTIPLIER if jopt.is_backbone_param(path)
                         else 1.0)
    seen = {n: (g["weight_decay"], g["lr"]) for g in topt.param_groups(tcfg, tmodel)
            for n in g["names"]}
    assert seen.keys() == {n for n, _ in tmodel.named_parameters()}
    for n in seen:
        assert seen[n] == (pytest.approx(want_wd[n].flatten()[0].item()),
                           pytest.approx(want_mult[n].flatten()[0].item())), n
    assert seen["sem_seg_head.predictor.query_embed.weight"][0] == 0.02
    assert seen["sem_seg_head.predictor.query_feat.weight"][0] == 0.02


def test_maskformer1_group_membership_matches_jax():
    """MaskFormer-v1's modules (TransformerEncoderPixelDecoder, the
    StandardTransformerDecoder with its own encoder): weight decay and LR
    multiplier of every parameter against the JAX package's rules.
    `query_embed`, the decoder's table, decays as an embedding in both
    (ROADMAP's `_EMBED_TOKENS` trap). One difference is kept: the JAX rule
    finds norms by path token (`_gn`, `norm`, ...) and misses the FPN's
    GroupNorms, whose token is `gn`; the port, as the reference, gives every
    norm module WEIGHT_DECAY_NORM."""
    from test_torch_maskformer1 import ADE, V1, VARIANTS

    jcfg, _, params, tcfg, tmodel, _ = _build_pair(
        V1 + VARIANTS["transformer_encoder"] + SOLVER + ["MODEL.BACKBONE.FREEZE_AT", "0"],
        IMG, ADE)
    s = jcfg.SOLVER

    def per_leaf(fn):
        return state_dict_from_jax_params(jax.tree_util.tree_map_with_path(
            lambda path, a: np.full(np.shape(a), fn(path), np.float32), params))

    want_wd = per_leaf(lambda path: s.WEIGHT_DECAY_NORM if jopt.is_norm_param(path) else
                       s.WEIGHT_DECAY_EMBED if jopt.is_embed_param(path) else s.WEIGHT_DECAY)
    want_mult = per_leaf(lambda path: s.BACKBONE_MULTIPLIER if jopt.is_backbone_param(path)
                         else 1.0)
    seen = {n: (g["weight_decay"], g["lr"]) for g in topt.param_groups(tcfg, tmodel)
            for n in g["names"]}
    assert seen.keys() == {n for n, _ in tmodel.named_parameters()}
    fpn_gn = set()
    for n in seen:
        want = (want_wd[n].flatten()[0].item(), want_mult[n].flatten()[0].item())
        if seen[n] != (pytest.approx(want[0]), pytest.approx(want[1])):
            fpn_gn.add(n)
            assert seen[n] == (s.WEIGHT_DECAY_NORM, 1.0) and want == (pytest.approx(s.WEIGHT_DECAY), 1.0), n
    assert fpn_gn == {f"sem_seg_head.pixel_decoder.{m}_{k}.norm.{w}" for m, ks in
                      (("adapter", (1, 2, 3)), ("layer", (1, 2, 3, 4))) for k in ks
                      for w in ("weight", "bias")}
    assert seen["sem_seg_head.predictor.query_embed.weight"][0] == 0.02
    assert seen["sem_seg_head.predictor.transformer.decoder.norm.weight"][0] == 0.01
    assert seen["sem_seg_head.predictor.transformer.encoder.layers.0.norm1.weight"][0] == 0.01
    assert seen["sem_seg_head.pixel_decoder.transformer.encoder.layers.1.linear1.weight"][0] == 0.05
