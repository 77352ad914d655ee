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


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("B,Q,M,shapes,P", [
    (1, 37, 3, [(9, 7), (4, 5)], 4),        # B*Q*M = 111: the last warp is not full
    (2, 5, 1, [(6, 6), (3, 3), (1, 1)], 4),  # M = 1, fewer pairs than one block
    (1, 130, 8, [(11, 13)], 4),             # L = 1
    (3, 33, 2, [(8, 8), (4, 4)], 1),        # P = 1
    (1, 21, 4, [(5, 5), (3, 3), (2, 2)], 7),  # L*P = 21: three rounds, the last ragged
])
def test_msda_kernel_matches_plain_at_ragged_shapes(cuda, dtype, tol, B, Q, M, shapes, P):
    value, loc, attn = (t.to(dtype) for t in _msda_inputs(cuda, B, Q, M, 32, shapes, P))
    got = msda_cuda.msda_fwd(value, shapes, loc, attn)
    want = msda_cuda.ms_deform_attn_plain(value.float(), shapes, loc.float(), attn.float())
    folded = msda_cuda.ms_deform_attn_folded(value.float(), shapes, loc.float(), attn.float())
    assert got.dtype == dtype and got.shape == (B, Q, M * 32)
    assert (got.float() - want).abs().max().item() <= tol
    assert (got.float() - folded).abs().max().item() <= tol


def test_msda_kernel_gives_zero_off_the_map_and_for_locations_not_finite(cuda):
    shapes = [(6, 5), (3, 2)]
    value, loc, attn = _msda_inputs(cuda, 1, 12, 2, 32, shapes, 2)
    loc[0, 0] = float("nan")
    loc[0, 1] = float("inf")
    loc[0, 2] = -7.0
    loc[0, 3] = 1e30
    got = msda_cuda.msda_fwd(value, shapes, loc, attn)
    folded = msda_cuda.ms_deform_attn_folded(value, shapes, loc, attn)
    assert torch.equal(got[0, :4], torch.zeros_like(got[0, :4]))
    assert (got - folded).abs().max().item() <= 1e-4


def test_msda_kernel_refuses_what_it_does_not_take(cuda):
    shapes = [(4, 4)]
    value, loc, attn = _msda_inputs(cuda, 1, 16, 2, 32, shapes, 2)
    # a contiguous view that starts 4 bytes into its storage: the kernel's
    # 16-byte loads would be misaligned
    shifted = torch.empty(value.numel() + 1, device=cuda)[1:].view_as(value).copy_(value)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte boundary"):
        msda_cuda.msda_fwd(shifted, shapes, loc, attn)
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


def _head_views(device, B, H, Q, S, dtype, seed):
    """q, k, v as `MultiheadAttention._heads` hands them over: (B, H, N, 32)
    views of (B, N, H * 32) projections, not contiguous."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((B, n, H * 32), generator=g, device=device).to(dtype)
                 .view(B, n, H, 32).transpose(1, 2) for n in (Q, S, S))


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("Q", [1, 7, 100, 130])
@pytest.mark.parametrize("S", [1, 31, 33, 77, 850, 3400, 13600])
def test_masked_attention_kernel_takes_strided_views_at_every_shape(cuda, dtype, tol, Q, S):
    """B = 2, the strided head views, both mask ranks, bool and uint8, against
    the plain version and (float32) against the plain function that repeats
    the kernel's tiles, chunks and 3xTF32 products."""
    B, H = 2, 8
    q, k, v = _head_views(cuda, B, H, Q, S, dtype, seed=Q * 100003 + S)
    assert S == 1 or not k.is_contiguous()
    g = torch.Generator(device=cuda).manual_seed(S)
    shared = torch.rand((B, Q, S), generator=g, device=cuda) < 0.7
    shared[:, :1] = True  # a fully masked row
    per_head = (torch.rand((B, H, Q, S), generator=g, device=cuda) < 0.5).to(torch.uint8)
    for m in (shared, per_head):
        got = mac.masked_attention(q, k, v, m)
        want = mac.masked_attention_plain(q.float(), k.float(), v.float(), m.bool())
        assert got.dtype == dtype and got.shape == (B, H, Q, 32)
        # the heads merge without a copy
        assert got.transpose(1, 2).is_contiguous()
        assert (got.float() - want).abs().max().item() <= tol
        if dtype == torch.float32:
            tiled = mac.masked_attention_tiled(q, k, v, m.bool())
            # the same arithmetic but for ex2.approx (2^-22) and summation order
            assert (got - tiled).abs().max().item() <= 1e-5
    assert torch.equal(mac.masked_attention(q, k, v, shared),
                       mac.masked_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                            shared))


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("chunk", [None, 64, 128, 448, 1024])
def test_masked_attention_kernel_with_fully_masked_rows_and_chunks(cuda, dtype, tol, chunk):
    """Row 0: every key masked (the mean of v, through every chunk). Row 1:
    only the first 64 keys visible (every other chunk fully masked). Row 2:
    only the last key visible. Row 3: only the ragged last tile masked."""
    B, H, Q, S = 2, 8, 21, 850
    q, k, v = _head_views(cuda, B, H, Q, S, dtype, seed=7)
    mask = torch.rand((B, Q, S), device=cuda) < 0.6
    mask[:, 0] = True
    mask[:, 1, :64], mask[:, 1, 64:] = False, True
    mask[:, 2, :-1], mask[:, 2, -1] = True, False
    mask[:, 3, :832], mask[:, 3, 832:] = False, True
    got = mac.masked_attn_fwd(q, k, v, mask, chunk=chunk).float()
    want = mac.masked_attention_plain(q.float(), k.float(), v.float(), mask)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol
    mean = v.float().mean(2, keepdim=True).expand(-1, -1, 1, -1)
    assert (got[:, :, :1] - mean).abs().max().item() <= tol
    assert (got[:, :, 2] - v.float()[:, :, -1]).abs().max().item() <= tol


def test_masked_attention_replays_twice_to_the_eager_result(cuda):
    """Captured with the keys split into chunks (scratch and merge kernel in
    the graph): two replays on changed inputs both give the eager result."""
    q, k, v = _head_views(cuda, 2, 8, 100, 3400, torch.float32, seed=9)
    mask = torch.rand((2, 100, 3400), device=cuda) < 0.7
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mac.masked_attn_fwd(q, k, v, mask)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = mac.masked_attn_fwd(q, k, v, mask)
    for _ in range(2):
        k.copy_(k.flip(2))
        mask.copy_(mask.flip(1))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, mac.masked_attn_fwd(q, k, v, mask))


def test_masked_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = _attn_inputs(cuda, 1, 2, 4, 40, 32)
    with pytest.raises(RuntimeError, match="forward-only"):
        mac.masked_attn_fwd(q.clone().requires_grad_(), k, v, mask)
    with pytest.raises(ValueError, match="mask"):
        mac.masked_attn_fwd(q, k, v, mask[:, :2])
    with pytest.raises(TypeError, match="mask"):
        mac.masked_attn_fwd(q, k, v, mask.float())
    with pytest.raises(ValueError, match="last dimension must be contiguous"):
        mac.masked_attn_fwd(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, mask)
    # rows of 33 floats: every other row starts off a 16-byte boundary
    wide = torch.randn((1, 2, 40, 33), device=cuda)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        mac.masked_attn_fwd(q, wide[..., :32], v, mask)
    with pytest.raises(ValueError, match="32 channels"):
        mac.masked_attn_fwd(q[..., :16].contiguous(), k[..., :16].contiguous(),
                            v[..., :16].contiguous(), mask)
    with pytest.raises(ValueError, match="do not match"):
        mac.masked_attn_fwd(q, k, v[:, :, :39], mask)
    with pytest.raises(ValueError, match="one device"):
        mac.masked_attn_fwd(q, k.cpu(), v, mask)
    with pytest.raises(ValueError, match="one device"):
        mac.masked_attn_fwd(q, k, v, mask.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        mac.masked_attn_fwd(q, k, v, mask.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="multiple of 64"):
        mac.masked_attn_fwd(q, k, v, mask, chunk=96)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width,n", [
    (5, 128, 1),          # one row
    (9, 40000, 3),        # a row longer than one block's share of units
    (9, 40001, 3),        # the same in 4-byte (float32) or 2-byte (bfloat16) units
    (300, 128, 300000),   # 75000 blocks of 4 rows along x
    (300, 8, 70000),      # short rows: teams of 2 lanes, 64 rows a block
    (64, 12, 1000),       # 3 units of 16 bytes in float32: teams of 4 lanes, one idle
])
def test_row_gather_kernel_is_exact_at_ragged_shapes(cuda, dtype, rows, width, n):
    g = torch.Generator(device=cuda).manual_seed(5)
    tab = torch.randn((rows, width), generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, rows, (n,), generator=g, device=cuda, dtype=torch.int32)
    got = rg.row_gather(tab, idx)
    assert got.shape == (n, width) and torch.equal(got, rg.row_gather_plain(tab, idx))


def test_row_gather_kernel_takes_a_misaligned_table(cuda):
    """A view 4 bytes into its storage: the kernel falls to 4-byte units."""
    tab = torch.randn(33 * 16 + 1, device=cuda)[1:].view(33, 16)
    idx = torch.arange(32, -1, -1, device=cuda, dtype=torch.int64)
    assert tab.data_ptr() % 16 != 0
    assert torch.equal(rg.row_gather(tab, idx), tab[idx])


def _graph_replay_matches_eager(fn, inputs):
    """Capture fn() into a CUDA graph, change the inputs in place, replay:
    the captured output must equal a fresh eager call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    for t in inputs:
        t.copy_(t.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, fn())


def test_wrappers_are_capturable_into_a_cuda_graph(cuda):
    """Every wrapper launches on the capturing stream, allocates through
    PyTorch and never synchronises; a launch error inside capture would raise."""
    shapes = [(9, 7), (4, 5)]
    value, loc, attn = _msda_inputs(cuda, 2, 37, 3, 32, shapes, 4)
    before = msda_cuda.LAUNCHES
    _graph_replay_matches_eager(lambda: msda_cuda.msda_fwd(value, shapes, loc, attn), [value])
    assert msda_cuda.LAUNCHES == before + 3  # warm-up, capture, eager: a replay is no call
    tab = torch.randn((300, 128), device=cuda)
    idx = torch.randint(0, 300, (64,), device=cuda, dtype=torch.int32)
    _graph_replay_matches_eager(lambda: rg.row_gather(tab, idx), [tab, idx])
    q, k, v, mask = _attn_inputs(cuda, 2, 8, 100, 850, 32)
    _graph_replay_matches_eager(lambda: mac.masked_attn_fwd(q, k, v, mask), [k, v])
    taps, w = _tap_inputs(cuda, 2, 101, 3, 8, 32, torch.float32)
    _graph_replay_matches_eager(lambda: tw.weight_taps(taps, w, 3, 8, 32), [taps])


def test_device_time_by_graph_replay_is_below_the_eager_reading(cuda):
    """`device_ms` reads the card, `cuda_ms` the slower of card and host: for
    a 64-row gather the host's issue time is the larger by far."""
    from mp_former_tpu_torch.utils.cuda_timing import cuda_ms, device_ms, issue_ms

    tab = torch.randn((256, 128), device=cuda)
    idx = torch.randint(0, 256, (64,), device=cuda, dtype=torch.int32)
    fn = lambda: rg.row_gather(tab, idx)
    device, eager, issue = device_ms(fn), cuda_ms(fn), issue_ms(fn)
    assert 0 < device < eager and 0 < issue
    assert device < 0.01  # a 32 KB copy: microseconds on the card


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,width,n,slots", [
    (16641, 128, 65536, 8),   # the probe's shape: a warp a row, a team a slot
    (9, 3, 35, 5),            # 4-byte units, teams of 4 lanes, many more teams than slots
    (50, 128, 8, 8),          # N = slots: one row a slot
    (50, 128, 4096, 1),       # one slot: all the teams of a block share it
    (300, 126, 3000, 3),      # W no multiple of 4: the 4-byte path, 4 units a lane
    (300, 1000, 640, 64),     # more slots than teams; 250 units of 16 bytes: 8 a lane
    (40, 8, 70000, 7),        # short rows, teams of 2 lanes, slots and teams coprime
    (300, 128, 1000000, 8),   # blocks at the staging limit of 2048 rows
])
def test_row_gather_sum_kernel_matches_plain(cuda, rows, width, n, slots, idx_dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    tab = torch.randn((rows, width), generator=g, device=cuda)
    idx = torch.randint(0, rows, (n,), generator=g, device=cuda).to(idx_dtype)
    before = rg.SUM_LAUNCHES
    got = rg.row_gather_sum(tab, idx, slots)
    want = rg.row_gather_sum_plain(tab.double(), idx, slots)
    assert rg.SUM_LAUNCHES == before + 1
    assert got.shape == (slots, width) and got.dtype == torch.float32
    # float32 sums of n / slots terms in an order that changes from run to run
    # (the blocks' atomic additions land as they come)
    assert (got.double() - want).abs().max().item() <= 1e-6 * n / slots + 1e-5


@pytest.mark.parametrize("rows_per_block", [8, 64, 2048, 4096])
def test_row_gather_sum_kernel_at_any_rows_per_block(cuda, rows_per_block):
    """4096 rows a block is above what a block stages: indices from global memory."""
    g = torch.Generator(device=cuda).manual_seed(6)
    tab = torch.randn((500, 128), generator=g, device=cuda)
    idx = torch.randint(0, 500, (20000,), generator=g, device=cuda, dtype=torch.int32)
    got = rg.row_gather_sum_fwd(tab, idx, 8, rows_per_block=rows_per_block)
    want = rg.row_gather_sum_plain(tab.double(), idx, 8)
    assert (got.double() - want).abs().max().item() <= 1e-6 * 20000 / 8 + 1e-5


def test_row_gather_sum_kernel_takes_a_misaligned_table(cuda):
    """A view 4 bytes into its storage: the kernel falls to 4-byte units."""
    tab = torch.randn(33 * 16 + 1, device=cuda)[1:].view(33, 16)
    idx = torch.arange(32, -1, -1, device=cuda, dtype=torch.int64).repeat(4)
    assert tab.data_ptr() % 16 != 0
    got = rg.row_gather_sum(tab, idx, 3)
    assert (got - rg.row_gather_sum_plain(tab, idx, 3)).abs().max().item() <= 1e-4


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


# ---------------------------------------------------------------------------
# The backward kernels (K1 backward: csrc/msda_bwd.cu; K3 backward:
# csrc/masked_attn_bwd.cu) against their plain versions, relative to each
# gradient's largest entry. float32: other summation orders (atomics), and in
# K3 the forward's 3xTF32 statistics against float32 recomputation. bfloat16:
# gradients rounded to 8 bits of mantissa.
BWD_TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)]


def _rel(got, want):
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
@pytest.mark.parametrize("B,Q,M,shapes,P", [
    (2, 1275, 8, [(25, 34), (13, 17), (7, 9)], 4),   # the model's layout, small
    (1, 37, 3, [(9, 7), (4, 5)], 4),                 # the last warp is not full
    (2, 5, 1, [(6, 6), (3, 3), (1, 1)], 4),          # M = 1, fewer pairs than one block
    (1, 130, 8, [(11, 13)], 4),                      # L = 1
    (3, 33, 2, [(8, 8), (4, 4)], 1),                 # P = 1
    (1, 21, 4, [(5, 5), (3, 3), (2, 2)], 7),         # L*P = 21: three rounds, the last ragged
])
def test_msda_backward_kernel_matches_plain(cuda, dtype, tol, B, Q, M, shapes, P):
    value, loc, attn = (t.to(dtype).contiguous()
                        for t in _msda_inputs(cuda, B, Q, M, 32, shapes, P, seed=3))
    grad_out = torch.randn((B, Q, M * 32), device=cuda).to(dtype)
    before = msda_cuda.BWD_LAUNCHES
    got = msda_cuda.msda_bwd(grad_out, value, shapes, loc, attn)
    assert msda_cuda.BWD_LAUNCHES == before + 1
    want = msda_cuda.ms_deform_attn_backward_plain(grad_out.float(), value.float(), shapes,
                                                   loc.float(), attn.float())
    for name, g, w, like in zip(("value", "loc", "attn"), got, want, (value, loc, attn)):
        assert g.dtype == dtype and g.shape == like.shape, name
        assert _rel(g, w) <= tol, name


def test_msda_function_passes_gradients_and_counts_launches(cuda):
    """Through the dispatcher: a tensor that requires a gradient goes through
    MSDeformAttnFunction (one forward and one backward launch); the gradients
    equal autograd of the plain version away from pixel borders."""
    shapes = [(12, 9), (6, 5)]
    B, Q, M, P = 2, 50, 4, 3
    value, loc, attn = _msda_inputs(cuda, B, Q, M, 32, shapes, P, seed=4)
    sizes = torch.tensor([[w, h] for h, w in shapes], device=cuda).view(1, 1, 1, 2, 1, 2)
    pix = loc * sizes - 0.5
    loc = (pix.floor() + (pix - pix.floor()).clamp(1e-2, 1 - 1e-2) + 0.5) / sizes
    grad_out = torch.randn((B, Q, M * 32), device=cuda)
    leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
    fwd, bwd = msda_cuda.LAUNCHES, msda_cuda.BWD_LAUNCHES
    ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]).backward(grad_out)
    assert (msda_cuda.LAUNCHES, msda_cuda.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    plain = [t.clone().requires_grad_() for t in (value, loc, attn)]
    want = torch.autograd.grad(msda_cuda.ms_deform_attn_plain(plain[0], shapes, plain[1],
                                                              plain[2]), plain, grad_out)
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= 1e-4
    # without a gradient asked for, the forward kernel alone
    ms_deform_attn(value, shapes, loc, attn)
    assert (msda_cuda.LAUNCHES, msda_cuda.BWD_LAUNCHES) == (fwd + 2, bwd + 1)


def test_msda_backward_kernel_against_finite_differences(cuda):
    """Directional derivatives of the kernel forward, float32: the function is
    linear in value and attention weights and bilinear in the locations, so a
    central difference is exact up to rounding (1e-2 relative at these sizes)."""
    shapes = [(8, 7), (4, 4)]
    B, Q, M, P = 1, 16, 2, 2
    value, loc, attn = _msda_inputs(cuda, B, Q, M, 32, shapes, P, seed=5)
    sizes = torch.tensor([[w, h] for h, w in shapes], device=cuda).view(1, 1, 1, 2, 1, 2)
    pix = loc * sizes - 0.5
    loc = (pix.floor() + (pix - pix.floor()).clamp(0.2, 0.8) + 0.5) / sizes
    grad_out = torch.randn((B, Q, M * 32), device=cuda)
    grads = msda_cuda.msda_bwd(grad_out, value, shapes, loc, attn)
    g = torch.Generator(device=cuda).manual_seed(6)
    for i, (x, eps) in enumerate(((value, 1e-1), (loc, 1e-3), (attn, 1e-1))):
        direction = torch.randn(x.shape, generator=g, device=cuda)
        args_hi, args_lo = [value, loc, attn], [value, loc, attn]
        args_hi[i], args_lo[i] = x + eps * direction, x - eps * direction
        hi = msda_cuda.msda_fwd(args_hi[0], shapes, args_hi[1], args_hi[2]).double()
        lo = msda_cuda.msda_fwd(args_lo[0], shapes, args_lo[1], args_lo[2]).double()
        numeric = ((hi - lo) * grad_out.double()).sum().item() / (2 * eps)
        analytic = (grads[i].double() * direction.double()).sum().item()
        assert abs(numeric - analytic) <= 1e-2 * max(abs(analytic), 1.0), i


def test_msda_backward_kernel_gives_nothing_off_the_map(cuda):
    shapes = [(6, 5), (3, 2)]
    value, loc, attn = _msda_inputs(cuda, 1, 12, 2, 32, shapes, 2)
    loc[0, 0] = float("nan")
    loc[0, 1] = float("inf")
    loc[0, 2] = -7.0
    loc[0, 3] = 1e30
    grad_out = torch.randn((1, 12, 64), device=cuda)
    gv, gl, ga = msda_cuda.msda_bwd(grad_out, value, shapes, loc, attn)
    want = msda_cuda.ms_deform_attn_backward_plain(grad_out, value, shapes, loc, attn)
    assert torch.isfinite(gv).all() and torch.isfinite(gl).all() and torch.isfinite(ga).all()
    assert gl[0, :4].abs().max().item() == 0 and ga[0, :4].abs().max().item() == 0
    for g, w in zip((gv, gl, ga), want):
        assert _rel(g, w) <= 1e-4


def test_msda_backward_kernel_refuses_what_it_does_not_take(cuda):
    shapes = [(4, 4)]
    value, loc, attn = _msda_inputs(cuda, 1, 16, 2, 32, shapes, 2)
    grad_out = torch.randn((1, 16, 64), device=cuda)
    with pytest.raises(ValueError, match="grad_out"):
        msda_cuda.msda_bwd(grad_out[:, :8].contiguous(), value, shapes, loc, attn)
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.msda_bwd(grad_out.transpose(1, 2), value, shapes, loc, attn)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        msda_cuda.msda_bwd(grad_out.double(), value.double(), shapes, loc.double(),
                           attn.double())


@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
@pytest.mark.parametrize("per_head,as_uint8", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("B,Q,S", [(8, 120, 256), (2, 100, 850), (1, 7, 33), (2, 130, 129),
                                   (3, 1, 1), (1, 17, 3400)])
def test_masked_attention_backward_kernel_matches_plain(cuda, dtype, tol, per_head, as_uint8,
                                                        B, Q, S):
    """The strided head views the decoder hands over and contiguous copies;
    masks shared by the heads and per head, bool and uint8; rows blocked
    everywhere; key counts that are no multiple of the 128-key block."""
    H = 8
    q, k, v = _head_views(cuda, B, H, Q, S, dtype, seed=7)
    g = torch.Generator(device=cuda).manual_seed(8)
    grad_out = torch.randn((B, Q, H, 32), generator=g, device=cuda).to(dtype).transpose(1, 2)
    mask = torch.rand((B, H, Q, S) if per_head else (B, Q, S), generator=g, device=cuda) < 0.7
    mask[..., 0, :] = True
    want = mac.masked_attention_backward_plain(grad_out.float(), q.float(), k.float(), v.float(),
                                               mask)
    m = mask.to(torch.uint8) if as_uint8 else mask
    for views in ((q, k, v, grad_out), tuple(t.contiguous() for t in (q, k, v, grad_out))):
        out, stats = mac.masked_attn_fwd(*views[:3], m, with_stats=True)
        before = mac.BWD_LAUNCHES
        got = mac.masked_attn_bwd(views[3], *views[:3], m, out, stats)
        assert mac.BWD_LAUNCHES == before + 1
        for name, x, w in zip("qkv", got, want):
            assert x.dtype == dtype and x.shape == w.shape, name
            assert _rel(x, w) <= tol, name
        assert got[0][:, :, 0].abs().max().item() == 0  # nothing to the q of a blocked row


def test_masked_attention_function_passes_gradients_and_counts_launches(cuda):
    B, H, Q, S = 2, 8, 20, 300
    q, k, v = _head_views(cuda, B, H, Q, S, torch.float32, seed=9)
    mask = torch.rand((B, H, Q, S), device=cuda) < 0.6
    mask[:, :, 0] = True
    grad_out = torch.randn((B, H, Q, 32), device=cuda)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = mac.LAUNCHES, mac.BWD_LAUNCHES
    mac.masked_attention(*leaves, mask).backward(grad_out)
    assert (mac.LAUNCHES, mac.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(mac.masked_attention_plain(*plain, mask), plain, grad_out)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.shape == w.shape and _rel(leaf.grad, w) <= 1e-4
    # serving: no gradient asked for, the forward alone and no statistics
    out = mac.masked_attention(q, k, v, mask)
    assert isinstance(out, torch.Tensor) and not out.requires_grad
    assert (mac.LAUNCHES, mac.BWD_LAUNCHES) == (fwd + 2, bwd + 1)


def test_masked_attention_backward_kernel_against_finite_differences(cuda):
    """Directional derivatives of the kernel forward in float32 (3xTF32
    products, ~1e-6 relative): central differences with a step of 1e-2 agree
    with the backward kernel to 2e-2 relative."""
    B, H, Q, S = 1, 2, 9, 70
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (torch.randn((B, H, n, 32), generator=g, device=cuda) for n in (Q, S, S))
    mask = torch.rand((B, H, Q, S), generator=g, device=cuda) < 0.5
    mask[:, :, 0] = True
    grad_out = torch.randn((B, H, Q, 32), generator=g, device=cuda)
    out, stats = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
    grads = mac.masked_attn_bwd(grad_out, q, k, v, mask, out, stats)
    eps = 1e-2
    for i in range(3):
        direction = torch.randn(grads[i].shape, generator=g, device=cuda)
        args_hi, args_lo = [q, k, v], [q, k, v]
        args_hi[i], args_lo[i] = args_hi[i] + eps * direction, args_lo[i] - eps * direction
        hi = mac.masked_attn_fwd(*args_hi, mask).double()
        lo = mac.masked_attn_fwd(*args_lo, mask).double()
        numeric = ((hi - lo) * grad_out.double()).sum().item() / (2 * eps)
        analytic = (grads[i].double() * direction.double()).sum().item()
        assert abs(numeric - analytic) <= 2e-2 * max(abs(analytic), 1.0), i


def test_masked_attention_backward_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = _attn_inputs(cuda, 1, 2, 5, 40, 32)
    out, stats = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
    grad_out = torch.randn_like(out)
    with pytest.raises(ValueError, match="stats"):
        mac.masked_attn_bwd(grad_out, q, k, v, mask, out, stats[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="expected"):
        mac.masked_attn_bwd(grad_out[:, :, :3], q, k, v, mask, out, stats)
    with pytest.raises(RuntimeError, match="forward-only"):
        mac.masked_attn_bwd(grad_out, q.clone().requires_grad_(), k, v, mask, out, stats)
    # the stats of a row blocked everywhere: the maximum is -1e9 log2(e), the sum S
    assert stats[0, 0, 0, 1].item() == 40.0
    assert stats[0, 0, 0, 0].item() == pytest.approx(-1e9 * 1.4426950408889634, rel=1e-6)


# ---------------------------------------------------------------------------
# The backward kernels' designs: K3 backward's key chunks, query tiles and dq
# by scratch and merge; K1 backward on the encoder's layout (Q = S).


@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("B,Q,S", [(8, 120, 1024), (8, 120, 4096), (2, 1, 31), (2, 120, 1),
                                   (1, 33, 33), (1, 300, 200)])
def test_masked_attention_backward_kernel_at_the_edges(cuda, dtype, tol, per_head, B, Q, S):
    """The training shapes, S = 1, 31 and 33, Q = 1 and Q above a block's 256
    rows; strided head views; every key chunk against the plain backward and
    the kernel's tiled arithmetic; dq the same bit for bit from run to run.
    Relative to each gradient's largest entry, or absolute below 1: with one
    key, dq and dk are 0 in exact arithmetic and rounding noise on both sides."""

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp(min=1.0)).item()

    H = 8
    q, k, v = _head_views(cuda, B, H, Q, S, dtype, seed=11)
    g = torch.Generator(device=cuda).manual_seed(12)
    grad_out = torch.randn((B, Q, H, 32), generator=g, device=cuda).to(dtype).transpose(1, 2)
    mask = torch.rand((B, H, Q, S) if per_head else (B, Q, S), generator=g, device=cuda) < 0.7
    mask[..., 0, :] = True
    out, stats = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
    want = mac.masked_attention_backward_plain(grad_out.float(), q.float(), k.float(), v.float(),
                                               mask)
    tiled = mac.masked_attention_backward_tiled(grad_out, q, k, v, mask, out, stats)
    for chunk in (None, 64, 128, -(-S // 64) * 64):
        got = mac.masked_attn_bwd(grad_out, q, k, v, mask, out, stats, chunk=chunk)
        for name, x, w, t in zip("qkv", got, want, tiled):
            assert x.dtype == dtype and x.shape == w.shape, name
            assert rel(x, w) <= tol, (name, chunk)
            assert rel(x, t) <= tol, (name, chunk)
        assert got[0][:, :, 0].abs().max().item() == 0
    again = mac.masked_attn_bwd(grad_out, q, k, v, mask, out, stats)
    first = mac.masked_attn_bwd(grad_out, q, k, v, mask, out, stats)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
@pytest.mark.parametrize("B,M,shapes,P", [
    (2, 8, [(16, 16), (32, 32), (64, 64)], 4),    # the training shape's levels
    (1, 3, [(7, 9), (1, 1)], 4),                  # a one-pixel level
    (2, 2, [(13, 17), (7, 9), (4, 5), (2, 3)], 2),  # four levels
])
def test_msda_backward_kernel_on_the_encoders_tokens(cuda, dtype, tol, B, M, shapes, P):
    """Q = S, the queries the tokens, as the encoder calls it: points a few
    pixels from the reference points (neighbouring queries add to the same
    pixels at once) and anywhere on the map, with points off the map and not
    finite."""
    from mp_former_tpu_torch.models.pixel_decoder.msdeformattn import _reference_points

    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value, loc, attn = _msda_inputs(cuda, B, S, M, 32, shapes, P, seed=13)
    g = torch.Generator(device=cuda).manual_seed(14)
    sizes = torch.tensor([[w, h] for h, w in shapes], device=cuda).view(1, 1, 1, L, 1, 2)
    ref = _reference_points(shapes, cuda)[None, :, None, :, None, :]
    near = ref + torch.randn((B, S, M, L, P, 2), generator=g, device=cuda) * 3.0 / sizes
    near[0, :5, 0, 0, 0, 0] = torch.tensor([float("nan"), float("inf"), -7.0, 1e30, 2.0],
                                           device=cuda)
    grad_out = torch.randn((B, S, M * 32), device=cuda).to(dtype)
    for where in (near, loc):
        args = [t.to(dtype).contiguous() for t in (value, where, attn)]
        want = msda_cuda.ms_deform_attn_backward_plain(grad_out.float(), args[0].float(), shapes,
                                                       args[1].float(), args[2].float())
        got = msda_cuda.msda_bwd(grad_out, args[0], shapes, args[1], args[2])
        for name, x, w, like in zip(("value", "loc", "attn"), got, want, args):
            assert x.dtype == dtype and x.shape == like.shape, name
            assert torch.isfinite(x).all(), name
            assert _rel(x, w) <= tol, name


def test_loader_fed_trainer_launches_the_training_kernels(cuda, tmp_path):
    """The released training recipe at full width, fed by `build_train_loader`
    from a dataset on disk (LSJ at 128x128, B = 2, 100 target slots): each
    step launches K1 6, K1 backward 6, K3 9 and K3 backward 9 times, K2 never,
    and the loader hands over pinned batches."""
    from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.data.datasets.coco import register_coco_instances
    from mp_former_tpu_torch.engine.trainer import Trainer
    from tools.make_synthetic_coco_torch import write_dataset

    path = write_dataset(str(tmp_path), images=4, size=160, classes=4, split="train2017", seed=0)
    name = f"gpu_trainer_{tmp_path.name}"
    if name not in DatasetCatalog:
        register_coco_instances(name, path, str(tmp_path / "coco" / "train2017"))
    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file("configs/coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml")
    cfg.merge_from_list([
        "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME", "MultiScaleMaskedTransformerDecoderMaskDN",
        "MODEL.MASK_FORMER.DN_MODE", "points", "MODEL.DN.NUM_DN", "1",
        "MODEL.DN.NOISE_SCALE", "0.0", "MODEL.MASK_FORMER.ALL_LY_DN", "True",
        "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.2", "MODEL.WEIGHTS", "",
        "INPUT.IMAGE_SIZE", "128", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2",
        "DATALOADER.NUM_WORKERS", "2", "DATASETS.TRAIN", f"('{name}',)", "DATASETS.TEST", "()",
        "OUTPUT_DIR", str(tmp_path / "out")])
    trainer = Trainer(cfg, device="cuda")
    pinned = []
    run_step = trainer.run_step
    trainer.run_step = lambda batch: (pinned.append(batch.images.is_pinned()), run_step(batch))[1]
    counters = (msda_cuda, "LAUNCHES"), (msda_cuda, "BWD_LAUNCHES"), (mac, "LAUNCHES"), \
        (mac, "BWD_LAUNCHES"), (tw, "LAUNCHES")
    before = [getattr(m, a) for m, a in counters]
    trainer.train()
    launches = [getattr(m, a) - b for (m, a), b in zip(counters, before)]
    assert launches == [12, 12, 18, 18, 0]
    assert pinned == [True, True]
