"""The port's LR schedules, parameter groups and AdamW step against the JAX
package's optax chain (`mp_former_tpu/engine/optimizer.py`).

The JAX chain adds `wd * p` after `scale_by_adam` and before the LR: decoupled
decay scaled by the LR, which is `torch.optim.AdamW`'s rule;
tests/test_torch_optimizer_steps.py shows it, with the Swin and MaskFormer-v1
groups. `state_dict_from_jax_params` carries gradients across (a linear map,
which a test here shows). Tolerance: 1e-6 relative on schedule values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine import optimizer as jopt

from mp_former_tpu_torch.engine import optimizer as topt
from mp_former_tpu_torch.engine.convert import named_gradients_from_jax, state_dict_from_jax_params

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
