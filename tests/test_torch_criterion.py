"""The port's SetCriterion against the JAX package's (`mp_former_tpu/models/
criterion.py`) on the same outputs, targets and assignments.

The two packages' random streams differ. Where a case needs draws (the
Bernoulli extras of `grid` mode, the points of `random` mode) the test records
what `jax.random.uniform` returns inside the JAX criterion and hands the port
the same numbers in the same order, by replacing the one function the port
draws with. The JAX criterion pads its pair axis to a static size with the
valid pairs first; the port takes the valid pairs only, so it reads the
leading rows of each recorded draw.

Tolerance 2e-5 relative (1e-6 absolute) on losses: float32 sums over up to
16 x 256 entries in another order. The `grid` mode's four main cases are in
tests/test_torch_criterion_grid.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.models import criterion as jcrit
from mp_former_tpu.models.matcher import HungarianMatcher as JMatcher
from mp_former_tpu.structures import Targets as JTargets
from mp_former_tpu_torch.models import criterion as tcrit
from mp_former_tpu_torch.models.matcher import HungarianMatcher
from mp_former_tpu_torch.structures import Targets

RTOL, ATOL = 2e-5, 1e-6
K = 6  # classes


def _outputs(rng, b, q, h, w, layers, dn_pad, dn_meta=None):
    def layer(nq):
        return {"pred_logits": rng.randn(b, nq, K + 1).astype(np.float32),
                "pred_masks": (rng.randn(b, nq, h, w) * 3).astype(np.float32)}

    out = layer(q)
    out["aux_outputs"] = [layer(q) for _ in range(layers - 1)]
    out["dn_out"] = None
    if dn_pad:
        dn = layer(dn_pad)
        dn["aux_outputs"] = [layer(dn_pad) for _ in range(layers - 1)]
        dn["dn_args"] = dn_meta
        out["dn_out"] = dn
    return out


def _convert(tree, leaf):
    if isinstance(tree, dict):
        return {k: _convert(v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v, leaf) for v in tree]
    return leaf(tree) if isinstance(tree, np.ndarray) else tree


def _targets(rng, b, n, size, valid):
    t = dict(labels=rng.randint(0, K, (b, n)), masks=rng.rand(b, n, size, size) > 0.6,
             boxes=rng.rand(b, n, 4).astype(np.float32), valid=np.asarray(valid, bool))
    jt = JTargets(jnp.asarray(t["labels"], jnp.int32), jnp.asarray(t["masks"]),
                  jnp.asarray(t["boxes"]), jnp.asarray(t["valid"]))
    tt = Targets(*(torch.from_numpy(t[k]) for k in ("labels", "masks", "boxes", "valid")))
    return jt, tt


def _criteria(mode, max_pairs, num_points, importance, dn_no_lb=False):
    args = dict(weight_dict={}, eos_coef=0.1, losses=["labels", "masks"], num_points=num_points,
                oversample_ratio=3.0, importance_sample_ratio=importance, dn_no_lb=dn_no_lb,
                max_pairs=max_pairs, point_sample_mode=mode)
    jc = jcrit.SetCriterion(K, JMatcher(2.0, 5.0, 5.0, num_points), point_matmul=False, **args)
    tc = tcrit.SetCriterion(K, HungarianMatcher(2.0, 5.0, 5.0, num_points), **args)
    return jc, tc


def _run_both(monkeypatch, jc, tc, outputs, jt, tt, assignments):
    """Both criteria on the same inputs; the port gets the JAX side's draws."""
    recorded = []
    real_uniform = jax.random.uniform

    def recording_uniform(*args, **kwargs):
        out = real_uniform(*args, **kwargs)
        recorded.append(out)  # a tracer: the jitted call returns it
        return out

    joutputs = _convert(outputs, jnp.asarray)  # closed over: `dn_args` stays static

    @jax.jit
    def criterion(assignments):
        return jc(joutputs, jt, jax.random.PRNGKey(0), assignments=assignments), list(recorded)

    monkeypatch.setattr(jax.random, "uniform", recording_uniform)
    want, draws = criterion(jnp.asarray(assignments, jnp.int32))
    monkeypatch.setattr(jax.random, "uniform", real_uniform)
    recorded = [np.asarray(d) for d in draws]

    def replayed_uniform(shape, generator, device):
        rec = recorded.pop(0)
        assert rec.ndim == len(shape) and all(r >= s for r, s in zip(rec.shape, shape))
        return torch.from_numpy(rec[tuple(slice(0, s) for s in shape)].copy())

    monkeypatch.setattr(tcrit, "uniform", replayed_uniform)
    got = tc(_convert(outputs, torch.from_numpy), tt, assignments=torch.from_numpy(assignments))
    assert not recorded, "the port drew fewer times than the JAX criterion"
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    return got


def _assignments(rng, layers, b, q, n):
    return np.stack([np.stack([rng.permutation(q)[:n] for _ in range(b)])
                     for _ in range(layers)]).astype(np.int64)


def test_grid_mode_dn_block_cut_to_max_num_matches_jax(monkeypatch):
    """The decoder cut the DN block to the first max_num slots (TPU.DN_MAX_GT):
    the criterion slices the targets the same way, and a DN slot reads its
    ground truth modulo the capped width (scalar 3)."""
    b, q, n, cap, h, w, layers = 2, 8, 6, 2, 8, 8, 2
    rng = np.random.RandomState(7)
    jt, tt = _targets(rng, b, n, 32, [[1, 1, 1, 0, 0, 0], [1, 0, 0, 0, 0, 0]])
    meta = {"pad_size": 3 * cap, "max_num": cap, "scalar": 3}
    outputs = _outputs(rng, b, q, h, w, layers, 3 * cap, meta)
    jc, tc = _criteria("grid", 64, 32, 1.0)
    got = _run_both(monkeypatch, jc, tc, outputs, jt, tt, _assignments(rng, layers, b, q, n))
    assert got["loss_mask_dn"].item() != 0.0


def test_grid_mode_threshold_from_a_subsample_matches_jax(monkeypatch):
    """Above 2048 grid points the k-th uncertainty is estimated on a strided
    subsample of 1024, in both packages."""
    b, q, n, h, w, layers = 1, 6, 3, 48, 48, 2
    rng = np.random.RandomState(8)
    jt, tt = _targets(rng, b, n, 64, [[1, 1, 0]])
    outputs = _outputs(rng, b, q, h, w, layers, 0)
    jc, tc = _criteria("grid", 16, 576, 0.75)
    _run_both(monkeypatch, jc, tc, outputs, jt, tt, _assignments(rng, layers, b, q, n))


@pytest.mark.parametrize("max_pairs", [0, 4])
def test_random_mode_losses_match_jax_on_recorded_points(monkeypatch, max_pairs):
    """`random` mode (the reference's point_rend sampling) on the JAX side's
    own points; `MAX_PAIRS 4` drops the batch's fifth valid pair in both.
    The JAX criterion samples with its exact 4-tap gather here."""
    b, q, n, h, w, layers = 2, 10, 5, 16, 16, 3
    rng = np.random.RandomState(5)
    jt, tt = _targets(rng, b, n, 64, [[1, 1, 1, 0, 0], [1, 1, 0, 0, 0]])
    meta = {"pad_size": 2 * n, "max_num": n, "scalar": 2}
    outputs = _outputs(rng, b, q, h, w, layers, 2 * n, meta)
    jc, tc = _criteria("random", max_pairs, 64, 0.75, dn_no_lb=True)
    got = _run_both(monkeypatch, jc, tc, outputs, jt, tt, _assignments(rng, layers, b, q, n))
    assert not any(k.startswith("loss_ce_dn") for k in got)  # DN_NO_LB


def test_matcher_inside_the_criterion_and_weighted_total():
    """Without assignments the criterion matches on its own points; the
    total weighs the keys of weight_dict only. No target at all gives finite
    losses and gradients."""
    b, q, n, h, w, layers = 2, 10, 5, 16, 16, 3
    rng = np.random.RandomState(9)
    _, tt = _targets(rng, b, n, 64, [[1, 1, 1, 0, 0], [0, 0, 0, 0, 0]])
    outputs = _convert(_outputs(rng, b, q, h, w, layers, 0), torch.from_numpy)
    _, tc = _criteria("grid", 512, 64, 0.75)
    tc.weight_dict = {"loss_ce": 2.0, "loss_mask_1": 5.0}
    losses = tc(outputs, tt, torch.Generator().manual_seed(0))
    total = tc.weighted_total(losses)
    torch.testing.assert_close(total, 2.0 * losses["loss_ce"] + 5.0 * losses["loss_mask_1"])
    assert tc.matcher_host_seconds > 0
    _, empty = _targets(rng, b, n, 64, np.zeros((b, n), bool))
    outputs["pred_masks"].requires_grad_()
    for mode in ("grid", "random"):
        tc.point_sample_mode = mode
        losses = tc(outputs, empty, torch.Generator().manual_seed(0))
        assert all(torch.isfinite(v) for v in losses.values())
        assert losses["loss_mask"].item() == 0.0
        losses["loss_mask"].backward()


def test_build_criterion_reads_the_same_keys_as_jax():
    from mp_former_tpu.config import (add_deeplab_config as jd, add_maskformer2_config as jm,
                                      get_cfg as jg)
    from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg

    def cfg(get, deeplab, mf2):
        c = get()
        deeplab(c)
        mf2(c)
        c.merge_from_list(["MODEL.MASK_FORMER.DEC_LAYERS", "4", "TPU.MAX_PAIRS", "0"])
        return c

    jc = jcrit.build_criterion(cfg(jg, jd, jm))
    tc = tcrit.build_criterion(cfg(get_cfg, add_deeplab_config, add_maskformer2_config))
    assert tc.weight_dict == jc.weight_dict and len(tc.weight_dict) == 24
    for attr in ("num_classes", "eos_coef", "num_points", "oversample_ratio",
                 "importance_sample_ratio", "dn_no_lb", "max_pairs", "point_sample_mode"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    with pytest.raises(ValueError, match="POINT_SAMPLE_MODE"):
        tcrit.SetCriterion(K, HungarianMatcher(), {}, 0.1, [], 1, 3.0, 0.75,
                           point_sample_mode="dense")
