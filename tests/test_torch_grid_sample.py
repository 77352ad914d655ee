"""`grid_sample` of the port against the JAX package's
(`mp_former_tpu/utils/interp.py:116`), same inputs made with numpy, with
and without `align_corners` (tests/test_torch_points.py holds
`point_sample`; its tolerance, 1e-5 absolute on values of magnitude ~1). Six
tests at most a file: the Tier-1 run queues such files behind its longest
one (ROADMAP.md, "Tier-1's clock").
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp_former_tpu.utils import interp as jinterp
from mp_former_tpu_torch.utils import interp as tinterp

from test_torch_points import TOL


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("B,H,W,C,P", [(2, 7, 9, 3, 50), (1, 16, 16, 1, 256), (3, 1, 5, 2, 11)])
def test_grid_sample_matches_jax(B, H, W, C, P, align_corners):
    rng = np.random.RandomState(0)
    x = rng.randn(B, H, W, C).astype(np.float32)
    # a tenth of the range lies off the map: zero padding
    grid = (rng.rand(B, P, 2) * 2.4 - 1.2).astype(np.float32)
    want = np.asarray(jinterp.grid_sample(jnp.asarray(x), jnp.asarray(grid),
                                          align_corners=align_corners))
    got = tinterp.grid_sample(torch.from_numpy(x), torch.from_numpy(grid),
                              align_corners=align_corners).numpy()
    assert got.shape == want.shape == (B, P, C)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
