"""The port's matcher cost matrix on shared points against the JAX
package's (`mp_former_tpu/models/matcher.py`), with a batch of unequal
instance counts and an image without instances (tests/test_torch_matcher.py
holds the pairwise costs and the assignments; its tolerance, 1e-5 absolute on
costs of magnitude ~1). Six tests at most a file: the Tier-1 run queues
such files behind its longest one (ROADMAP.md, "Tier-1's clock").
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.models import matcher as jm
from mp_former_tpu_torch.models import matcher as tm

from test_torch_matcher import TOL, _both, _targets


@pytest.mark.parametrize("valid_counts", [(3, 1), (5, 0)])
def test_cost_matrix_matches_jax_on_shared_points(valid_counts):
    rng = np.random.RandomState(2)
    b, q, n, h, w, points = 2, 8, 5, 16, 16, 256
    t = _targets(rng, b, n, 64, 64, valid_counts)
    logits = rng.randn(b, q, 6).astype(np.float32)
    masks = rng.randn(b, q, h, w).astype(np.float32) * 2
    key = jax.random.PRNGKey(7)
    coords = np.asarray(jax.random.uniform(key, (b, points, 2)))  # what the JAX matcher draws
    jt, tt = _both(t)
    want = np.asarray(jm.match_cost_matrix(jnp.asarray(logits), jnp.asarray(masks), jt, points,
                                           2.0, 5.0, 5.0, key))
    got = tm.match_cost_matrix(torch.from_numpy(logits), torch.from_numpy(masks), tt, points,
                               2.0, 5.0, 5.0, coords=torch.from_numpy(coords)).numpy()
    assert got.shape == want.shape == (b, q, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the matcher class, and its assignment against the JAX package's host solver
    matcher = tm.HungarianMatcher(2.0, 5.0, 5.0, points)
    assign = matcher(torch.from_numpy(logits), torch.from_numpy(masks), tt,
                     coords=torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(assign, jm._lsa_host(want))
