"""The row-gather kernels' plain versions against numpy, at the shapes of the
JAX package's three row-gather probes (scaled down where that costs nothing).
The CUDA kernels are compared with the plain versions on the card, in
tests/test_torch_kernels_gpu.py and by tools/probe_torch_row_gather.py.
"""

import numpy as np
import pytest
import torch

from mp_former_tpu_torch.ops import row_gather as rg

torch.set_num_threads(2)


def _inputs(seed, rows, width, n, idx_dtype=np.int32):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, width).astype(np.float32),
            rng.randint(0, rows, (n,)).astype(idx_dtype))


@pytest.mark.parametrize("rows,width,n", [(256, 128, 64), (101 * 137, 128, 1024), (7, 5, 33)])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_row_gather_matches_numpy(rows, width, n, idx_dtype):
    tab, idx = _inputs(0, rows, width, n, idx_dtype)
    got = rg.row_gather(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), tab[idx])


def test_row_gather_bfloat16_is_exact():
    tab, idx = _inputs(1, 50, 128, 40)
    tab_bf = torch.from_numpy(tab).to(torch.bfloat16)
    got = rg.row_gather(tab_bf, torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), tab_bf.float().numpy()[idx])


@pytest.mark.parametrize("rows,width,n,slots", [(16641, 128, 65536, 8), (9, 3, 35, 5)])
def test_row_gather_sum_matches_numpy(rows, width, n, slots):
    tab, idx = _inputs(2, rows, width, n)
    want = np.zeros((slots, width), np.float64)
    np.add.at(want, np.arange(n) % slots, tab[idx].astype(np.float64))  # row i -> slot i % slots
    got = rg.row_gather_sum(torch.from_numpy(tab), torch.from_numpy(idx), slots)
    assert got.shape == (slots, width) and got.dtype == torch.float32
    # float32 sums of n / slots terms of magnitude ~1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * n / slots)


def test_cpu_tensors_take_the_plain_versions():
    tab, idx = _inputs(3, 20, 8, 16)
    t, i = torch.from_numpy(tab), torch.from_numpy(idx)
    before = (rg.GATHER_LAUNCHES, rg.SUM_LAUNCHES)
    np.testing.assert_array_equal(rg.row_gather(t, i).numpy(), rg.row_gather_plain(t, i).numpy())
    np.testing.assert_array_equal(rg.row_gather_sum(t, i, 4).numpy(),
                                  rg.row_gather_sum_plain(t, i, 4).numpy())
    assert (rg.GATHER_LAUNCHES, rg.SUM_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        rg.row_gather_fwd(t, i)
    with pytest.raises(ValueError, match="CUDA"):
        rg.row_gather_sum_fwd(t, i, 4)


def test_wrong_arguments_raise():
    tab, idx = _inputs(4, 20, 8, 16)
    t, i = torch.from_numpy(tab), torch.from_numpy(idx)
    with pytest.raises(ValueError, match=r"\(R, W\)"):
        rg.row_gather(t[None], i)
    with pytest.raises(TypeError, match="int32 or int64"):
        rg.row_gather(t, i.float())
    with pytest.raises(ValueError, match="multiple of slots"):
        rg.row_gather_sum(t, i, 5)
