"""`point_sample` of the port against the JAX package's
(`mp_former_tpu/utils/interp.py:169`), same inputs made with numpy
(`grid_sample`: tests/test_torch_grid_sample.py).

Tolerance 1e-5 absolute on values of magnitude ~1: both are float32 bilinear
sums of four taps; the two round the pixel coordinate in a different order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp_former_tpu.utils import interp as jinterp
from mp_former_tpu_torch.utils import interp as tinterp

TOL = 1e-5


@pytest.mark.parametrize("B,H,W,C,P", [(2, 16, 24, 5, 300), (1, 4, 4, 1, 7)])
def test_point_sample_matches_jax(B, H, W, C, P):
    rng = np.random.RandomState(1)
    x = rng.randn(B, H, W, C).astype(np.float32)
    coords = (rng.rand(B, P, 2) * 1.2 - 0.1).astype(np.float32)
    want = np.asarray(jinterp.point_sample(jnp.asarray(x), jnp.asarray(coords)))
    got = tinterp.point_sample(torch.from_numpy(x), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_point_sample_passes_gradients_to_the_map_only_where_taps_fall():
    x = torch.zeros((1, 4, 4, 1), requires_grad=True)
    coords = torch.tensor([[[0.375, 0.375], [5.0, 5.0]]])  # pixel (1, 1) exactly; far off
    tinterp.point_sample(x, coords).sum().backward()
    want = torch.zeros(4, 4)
    want[1, 1] = 1.0
    torch.testing.assert_close(x.grad[0, :, :, 0], want)
