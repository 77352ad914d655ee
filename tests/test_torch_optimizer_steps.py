"""The port's AdamW step and the Swin and MaskFormer-v1 parameter groups
against the JAX package's optax chain (`mp_former_tpu/engine/optimizer.py`);
tests/test_torch_optimizer.py holds the schedules and the other groups. Six
tests at most a file: the Tier-1 run queues such files behind its longest
one (ROADMAP.md, "Tier-1's clock").

The JAX chain adds `wd * p` after `scale_by_adam` and before the LR: decoupled
decay scaled by the LR, which is `torch.optim.AdamW`'s rule. The test shows it
on the tiny model's full parameter tree with the same gradients on both sides,
carried across by `state_dict_from_jax_params`. Tolerance: parameters after
two steps within 1e-6 absolute (a few float32 ulps of parameters of size ~1,
each moved twice by about LR = 1e-2).
"""

import copy

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

from test_torch_optimizer import SOLVER, _random_like, _zero_frozen_bn
from test_torch_slice import IMG, SMALL, _build_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return _build_pair(SMALL + SOLVER + ["MODEL.BACKBONE.FREEZE_AT", "0"], IMG)


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
