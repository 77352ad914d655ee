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


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("rows,width,n,slots", [
    (300, 126, 3000, 3),   # W no multiple of 4
    (50, 128, 4096, 1),    # one slot
    (50, 128, 8, 8),       # N = slots: one row a slot
    (300, 1000, 640, 64),  # more slots than a block has teams
    (40, 8, 70000, 7),     # short rows
])
def test_row_gather_sum_matches_numpy_at_ragged_shapes(rows, width, n, slots, idx_dtype):
    tab, idx = _inputs(5, rows, width, n, idx_dtype)
    want = np.zeros((slots, width), np.float64)
    np.add.at(want, np.arange(n) % slots, tab[idx].astype(np.float64))
    got = rg.row_gather_sum(torch.from_numpy(tab), torch.from_numpy(idx), slots)
    assert got.shape == (slots, width) and got.dtype == torch.float32
    # float32 sums of n / slots terms of magnitude ~1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(1, n / slots))


def test_row_gather_sum_takes_a_misaligned_table_view():
    """A view 4 bytes into its storage (the CUDA kernel then reads 4-byte units)."""
    rng = np.random.RandomState(6)
    tab = torch.from_numpy(rng.randn(33 * 16 + 1).astype(np.float32))[1:].view(33, 16)
    idx = torch.arange(32, -1, -1, dtype=torch.int64).repeat(4)
    assert tab.data_ptr() % 16 != 0 and tab.is_contiguous()
    want = np.zeros((3, 16), np.float64)
    np.add.at(want, np.arange(132) % 3, tab.numpy()[idx.numpy()].astype(np.float64))
    np.testing.assert_allclose(rg.row_gather_sum(tab, idx, 3).numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,slots,sms", [(65536, 8, 132), (35, 5, 132), (8, 8, 132), (10 ** 7, 8, 132),
                                         (10 ** 6, 5000, 132), (0, 3, 132), (4096, 1, 8)])
def test_sum_rows_per_block_is_whole_slots_and_covers_the_card(n, slots, sms):
    per_block = rg._sum_rows_per_block(n, slots, sms)
    assert per_block >= slots and per_block % slots == 0
    blocks = -(-n // per_block)
    # about SUM_BLOCKS_PER_SM blocks an SM, unless a block is at its limits
    if slots <= per_block < rg.SUM_MAX_STAGED_ROWS // slots * slots and per_block > slots:
        assert blocks <= rg.SUM_BLOCKS_PER_SM * sms
    if n == 65536:
        assert (per_block, blocks) == (256, 256)


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
