"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q
"""

import pytest
import torch

from mp_former_tpu_torch.ops import masked_attention_cuda as mac
from mp_former_tpu_torch.ops import msda_cuda
from mp_former_tpu_torch.ops import row_gather as rg
from mp_former_tpu_torch.ops import tap_weighting as tw
from mp_former_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_headshare

pytestmark = pytest.mark.gpu

# kernel vs plain: float32 differs in summation order and in how the sampling
# coordinate is rounded; bfloat16 outputs keep 8 bits of mantissa
TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _msda_inputs(device, B, Q, M, D, shapes, P, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    S = sum(h * w for h, w in shapes)
    value = torch.randn((B, S, M, D), generator=g, device=device)
    loc = torch.rand((B, Q, M, len(shapes), P, 2), generator=g, device=device) * 1.4 - 0.2
    attn = torch.randn((B, Q, M, len(shapes) * P), generator=g, device=device).softmax(-1)
    return value, loc, attn.view(B, Q, M, len(shapes), P)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("shapes,P", [([(25, 34), (13, 17), (7, 9)], 4), ([(5, 3), (1, 1)], 3)])
def test_msda_kernel_matches_plain(cuda, dtype, tol, shapes, P):
    S = sum(h * w for h, w in shapes)
    value, loc, attn = (t.to(dtype) for t in _msda_inputs(cuda, 2, S, 8, 32, shapes, P))
    before = msda_cuda.LAUNCHES
    got = ms_deform_attn(value, shapes, loc, attn)
    want = msda_cuda.ms_deform_attn_plain(value.float(), shapes, loc.float(), attn.float())
    assert msda_cuda.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (2, S, 8 * 32)
    assert (got.float() - want).abs().max().item() <= tol


def test_msda_kernel_refuses_what_it_does_not_take(cuda):
    shapes = [(4, 4)]
    value, loc, attn = _msda_inputs(cuda, 1, 16, 2, 32, shapes, 2)
    with pytest.raises(RuntimeError, match="forward-only"):
        msda_cuda.msda_fwd(value.clone().requires_grad_(), shapes, loc, attn)
    with pytest.raises(ValueError, match="32 channels"):
        msda_cuda.msda_fwd(value[..., :16].contiguous(), shapes, loc, attn)
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.msda_fwd(value, shapes, loc.transpose(1, 2), attn)


def _attn_inputs(device, B, H, Q, S, D, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, H, n, D), generator=g, device=device) for n in (Q, S, S))
    mask = torch.rand((B, Q, S), generator=g, device=device) < 0.7
    mask[:, :3] = True  # fully masked rows: uniform over the keys
    return q, k, v, mask


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("Q,S", [(100, 850), (7, 33), (130, 3400)])
def test_masked_attention_kernel_matches_plain(cuda, dtype, tol, Q, S):
    q, k, v, mask = _attn_inputs(cuda, 2, 8, Q, S, 32)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    mask_h = torch.rand((2, 8, Q, S), device=cuda) < 0.5
    for m in (mask, mask_h):
        before = mac.LAUNCHES
        got = mac.masked_attention(q, k, v, m)
        want = mac.masked_attention_plain(q.float(), k.float(), v.float(), m)
        assert mac.LAUNCHES == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        assert (got.float() - want).abs().max().item() <= tol


def test_masked_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = _attn_inputs(cuda, 1, 2, 4, 40, 32)
    with pytest.raises(RuntimeError, match="forward-only"):
        mac.masked_attn_fwd(q.clone().requires_grad_(), k, v, mask)
    with pytest.raises(ValueError, match="mask"):
        mac.masked_attn_fwd(q, k, v, mask[:, :2])
    with pytest.raises(TypeError, match="mask"):
        mac.masked_attn_fwd(q, k, v, mask.float())


def _tap_inputs(device, b, q, n_points, n_heads, d, dtype, seed=2):
    g = torch.Generator(device=device).manual_seed(seed)
    taps = torch.randn((b, n_points * q, 4 * n_heads * d), generator=g, device=device)
    # far from uniform, so a wrong row or lane order shows
    w = torch.rand((b, n_points * q, 4 * n_heads), generator=g, device=device) ** 3
    return taps.to(dtype), w.to(dtype)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,q,n_points,n_heads", [
    (1, 850, 4, 8),     # head-shared engine, one image
    (8, 850, 4, 1),     # per-head patch tables as the batch
    (2, 101, 3, 8),     # ragged Q, P and Q coprime
    (8, 96, 12, 1),     # levels concatenated along the points
])
def test_tap_weighting_kernel_matches_plain(cuda, dtype, tol, b, q, n_points, n_heads):
    taps, w = _tap_inputs(cuda, b, q, n_points, n_heads, 32, dtype)
    before = tw.LAUNCHES
    got = tw.weight_taps(taps, w, n_points, n_heads, 32)
    want = tw.weight_taps_plain(taps.float(), w.float(), n_points, n_heads, 32)
    assert tw.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (b, q, n_heads * 32)
    # sums of 4 * P products of magnitude ~1: scale the tolerance with P
    assert (got.float() - want).abs().max().item() <= tol * n_points


def test_tap_weighting_kernel_takes_unaligned_rows(cuda):
    """d = 6 is no multiple of 4: one channel per thread."""
    taps, w = _tap_inputs(cuda, 3, 37, 5, 2, 6, torch.float32)
    got = tw.weight_taps(taps, w, 5, 2, 6)
    want = tw.weight_taps_plain(taps, w, 5, 2, 6)
    assert (got - want).abs().max().item() <= 1e-4


def test_tap_weighting_kernel_refuses_what_it_does_not_take(cuda):
    taps, w = _tap_inputs(cuda, 2, 16, 4, 2, 32, torch.float32)
    with pytest.raises(RuntimeError, match="forward-only"):
        tw.weight_taps(taps.clone().requires_grad_(), w, 4, 2, 32)
    with pytest.raises(ValueError, match="w .* is not"):
        tw.weight_taps(taps, w[..., :4].contiguous(), 4, 2, 32)
    with pytest.raises(ValueError, match="not \\(B, P\\*Q, T\\*M\\*D\\)"):
        tw.weight_taps(taps, w, 5, 2, 32)
    with pytest.raises(ValueError, match="contiguous"):
        tw.weight_taps(taps.transpose(0, 1).contiguous().transpose(0, 1), w, 4, 2, 32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tw.weight_taps(taps, w.half(), 4, 2, 32)


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_sampling_routes_agree_on_the_card(cuda, dtype, tol):
    """K1, the patch-table route through K2, and (on shared locations) the
    head-shared engine through K2 compute one function."""
    shapes = [(25, 34), (13, 17), (7, 9)]
    S = sum(h * w for h, w in shapes)
    value, loc, attn = (t.to(dtype) for t in _msda_inputs(cuda, 2, S, 8, 32, shapes, 4))
    loc = loc[:, :, :1].expand(-1, -1, 8, -1, -1, -1).contiguous()  # every head at head 0's
    want = msda_cuda.ms_deform_attn_plain(value.float(), shapes, loc.float(), attn.float())
    k1, k2 = msda_cuda.LAUNCHES, tw.LAUNCHES
    via_k1 = ms_deform_attn(value, shapes, loc, attn)
    via_k2 = ms_deform_attn(value, shapes, loc, attn, pallas_weighting=True)
    shared = ms_deform_attn_headshare(value, shapes, loc[:, :, 0].contiguous(), attn)
    assert (msda_cuda.LAUNCHES, tw.LAUNCHES) == (k1 + 1, k2 + 2 * len(shapes))
    for got in (via_k1, via_k2, shared):
        assert got.dtype == dtype
        # bfloat16: the K2 routes round the folded weights and each level's sum
        assert (got.float() - want).abs().max().item() <= tol * (1 if dtype == torch.float32 else 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,width,n", [(256, 128, 64), (101 * 137, 128, 1024), (7, 5, 33)])
def test_row_gather_kernel_is_exact(cuda, dtype, idx_dtype, rows, width, n):
    g = torch.Generator(device=cuda).manual_seed(3)
    tab = torch.randn((rows, width), generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, rows, (n,), generator=g, device=cuda).to(idx_dtype)
    before = rg.GATHER_LAUNCHES
    got = rg.row_gather(tab, idx)
    assert rg.GATHER_LAUNCHES == before + 1
    assert got.dtype == dtype and torch.equal(got, rg.row_gather_plain(tab, idx))


@pytest.mark.parametrize("rows,width,n,slots", [(16641, 128, 65536, 8), (9, 3, 35, 5)])
def test_row_gather_sum_kernel_matches_plain(cuda, rows, width, n, slots):
    g = torch.Generator(device=cuda).manual_seed(4)
    tab = torch.randn((rows, width), generator=g, device=cuda)
    idx = torch.randint(0, rows, (n,), generator=g, device=cuda, dtype=torch.int32)
    before = rg.SUM_LAUNCHES
    got = rg.row_gather_sum(tab, idx, slots)
    want = rg.row_gather_sum_plain(tab.double(), idx, slots)
    assert rg.SUM_LAUNCHES == before + 1
    assert got.shape == (slots, width) and got.dtype == torch.float32
    # float32 sums of n / slots terms in an order that changes from run to run
    assert (got.double() - want).abs().max().item() <= 1e-6 * n / slots + 1e-5


def test_row_gather_kernels_refuse_what_they_do_not_take(cuda):
    tab = torch.randn((20, 8), device=cuda)
    idx = torch.arange(16, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 or int64"):
        rg.row_gather(tab, idx.float())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rg.row_gather(tab.half(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        rg.row_gather(tab.t().contiguous().t(), idx)
    with pytest.raises(TypeError, match="float32"):
        rg.row_gather_sum(tab.bfloat16(), idx, 4)
    with pytest.raises(ValueError, match="multiple of slots"):
        rg.row_gather_sum(tab, idx, 5)
    with pytest.raises(ValueError, match="one device"):
        rg.row_gather(tab, idx.cpu())
