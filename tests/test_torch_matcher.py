"""The port's matcher against the JAX package's (`mp_former_tpu/models/
matcher.py`): pairwise costs, the invalid-column fill and the assignments
(the cost matrix on shared points: tests/test_torch_matcher_costs.py).

Tolerances: 1e-5 absolute on costs of magnitude ~1 (float32 sums over the
points in another order); assignments are compared exactly, on costs that have
no near ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp_former_tpu.models import matcher as jm
from mp_former_tpu.structures import Targets as JTargets
from mp_former_tpu_torch.models import matcher as tm
from mp_former_tpu_torch.structures import Targets

TOL = 1e-5


def _targets(rng, b, n, h, w, valid_counts, classes=5):
    masks = rng.rand(b, n, h, w) < 0.4
    valid = np.zeros((b, n), bool)
    for i, c in enumerate(valid_counts):
        valid[i, :c] = True
    return dict(labels=rng.randint(0, classes, (b, n)), masks=masks,
                boxes=rng.rand(b, n, 4).astype(np.float32), valid=valid)


def _both(t):
    jt = JTargets(jnp.asarray(t["labels"], jnp.int32), jnp.asarray(t["masks"]),
                  jnp.asarray(t["boxes"]), jnp.asarray(t["valid"]))
    tt = Targets(*(torch.from_numpy(t[k]) for k in ("labels", "masks", "boxes", "valid")))
    return jt, tt


@pytest.mark.parametrize("fn", ["batch_dice_cost", "batch_sigmoid_ce_cost"])
def test_pairwise_costs_match_jax(fn):
    rng = np.random.RandomState(0)
    inputs = rng.randn(2, 6, 50).astype(np.float32) * 3
    targets = (rng.rand(2, 4, 50) < 0.5).astype(np.float32)
    want = np.asarray(getattr(jm, fn)(jnp.asarray(inputs), jnp.asarray(targets)))
    got = getattr(tm, fn)(torch.from_numpy(inputs), torch.from_numpy(targets)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_fill_invalid_columns_matches_jax():
    rng = np.random.RandomState(1)
    cost = rng.randn(3, 5, 4).astype(np.float32)
    cost[0, 1, 0] = np.nan
    cost[1, 2, 1] = np.inf
    valid = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]], bool)
    want = np.asarray(jm.fill_invalid_columns(jnp.asarray(cost), jnp.asarray(valid)))
    got = tm.fill_invalid_columns(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_assignments_match_the_jax_host_solver_and_are_permutations():
    rng = np.random.RandomState(3)
    cost = rng.rand(6, 9, 4).astype(np.float32)
    want = jm._lsa_host(cost)
    np.testing.assert_array_equal(tm.lsa_host(cost), want)
    got = tm.hungarian_assign(torch.from_numpy(cost).reshape(2, 3, 9, 4))
    assert got.shape == (2, 3, 4) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.reshape(6, 4).numpy(), want)
    for row in got.reshape(6, 4).numpy():
        assert len(set(row.tolist())) == 4


def test_points_come_from_the_generator_where_no_coords_are_given():
    rng = np.random.RandomState(4)
    t = _targets(rng, 1, 3, 32, 32, (2,))
    _, tt = _both(t)
    logits = torch.from_numpy(rng.randn(1, 4, 6).astype(np.float32))
    masks = torch.from_numpy(rng.randn(1, 4, 8, 8).astype(np.float32))
    costs = [tm.match_cost_matrix(logits, masks, tt, 64, 1.0, 1.0, 1.0,
                                  generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    torch.testing.assert_close(costs[0], costs[1], rtol=0, atol=0)
    assert not torch.equal(costs[0], costs[2])
    with pytest.raises(ValueError, match="all matching costs are 0"):
        tm.HungarianMatcher(0, 0, 0)
