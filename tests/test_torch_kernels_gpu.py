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
        tw.tap_weight_fwd(taps.clone().requires_grad_(), w, 4, 2, 32)
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
        out, stats, out32 = mac.masked_attn_fwd(*views[:3], m, with_stats=True)
        assert out32.dtype == torch.float32 and (out32 is out) == (dtype == torch.float32)
        before = mac.BWD_LAUNCHES
        got = mac.masked_attn_bwd(views[3], *views[:3], m, out32, stats)
        assert mac.BWD_LAUNCHES == before + 1
        for name, x, w in zip("qkv", got, want):
            assert x.dtype == dtype and x.shape == w.shape, name
            assert _rel(x, w) <= tol, name
        assert got[0][:, :, 0].abs().max().item() == 0  # nothing to the q of a blocked row


@pytest.mark.parametrize("S", [1024, 16384])
def test_masked_attention_kernel_on_values_with_a_common_offset(cuda, S):
    """Weights spread over the keys and values sharing an offset (the
    decoder's features): the float32 kernel sums each 32-key step from 0 in
    the tensor cores and the running output with round-to-nearest FMAs, so it
    stays within 1e-5 of its own tiled arithmetic (relative to the largest
    entry); summed in the tensor cores' accumulator, whose adds round toward
    zero, it had drifted by 1e-4 at S = 16384."""
    g = torch.Generator(device=cuda).manual_seed(S)
    B, H, Q, D = 2, 8, 200, 32
    q = 0.3 * torch.randn((B, H, Q, D), generator=g, device=cuda)
    k = torch.randn((B, H, S, D), generator=g, device=cuda)
    v = 3.0 + 0.25 * torch.randn((B, H, S, D), generator=g, device=cuda)
    mask = torch.rand((B, Q, S), generator=g, device=cuda) < 0.1
    got = mac.masked_attention(q, k, v, mask)
    tiled = mac.masked_attention_tiled(q, k, v, mask)
    assert (got - tiled).abs().max().item() <= 1e-5 * tiled.abs().max().item()
    plain = mac.masked_attention_plain(q, k, v, mask)
    assert (got - plain).abs().max().item() <= 1e-4 * plain.abs().max().item()


@pytest.mark.parametrize("dtype,fwd_tol,bwd_tol", [(torch.float32, 1e-4, 1e-4),
                                                   (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("B,S", [(1, 850), (1, 3400), (1, 13600), (2, 4096)])
def test_masked_attention_kernels_at_200_queries(cuda, dtype, fwd_tol, bwd_tol, B, S):
    """The Swin-L recipes' 200 queries: 13 tiles of 16 rows, the last one
    ragged, two forward blocks a (batch, head). Strided head views, a mask
    shared by the heads and one per head with fully masked rows; the forward
    against the plain version and (float32) the kernel's tiled arithmetic,
    the backward against the plain backward and its tiled arithmetic, dq the
    same bit for bit from run to run."""
    H, Q = 8, 200
    q, k, v = _head_views(cuda, B, H, Q, S, dtype, seed=Q + S)
    g = torch.Generator(device=cuda).manual_seed(S)
    grad_out = torch.randn((B, Q, H, 32), generator=g, device=cuda).to(dtype).transpose(1, 2)
    shared = torch.rand((B, Q, S), generator=g, device=cuda) < 0.7
    shared[:, :3] = True
    per_head = torch.rand((B, H, Q, S), generator=g, device=cuda) < 0.5
    per_head[:, :, -1] = True
    for m in (shared, per_head):
        want = mac.masked_attention_plain(q.float(), k.float(), v.float(), m)
        got = mac.masked_attention(q, k, v, m)
        assert got.shape == (B, H, Q, 32) and (got.float() - want).abs().max().item() <= fwd_tol
        if dtype == torch.float32:
            assert (got - mac.masked_attention_tiled(q, k, v, m)).abs().max().item() <= 1e-5
        _, stats, out32 = mac.masked_attn_fwd(q, k, v, m, with_stats=True)
        want = mac.masked_attention_backward_plain(grad_out.float(), q.float(), k.float(),
                                                   v.float(), m)
        tiled = mac.masked_attention_backward_tiled(grad_out, q, k, v, m, out32, stats)
        got = mac.masked_attn_bwd(grad_out, q, k, v, m, out32, stats)
        for name, x, w, t in zip("qkv", got, want, tiled):
            assert x.dtype == dtype and x.shape == w.shape, name
            assert _rel(x, w) <= bwd_tol and _rel(x, t) <= bwd_tol, name
        again = mac.masked_attn_bwd(grad_out, q, k, v, m, out32, stats)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_masked_attention_backward_kernel_bfloat16_takes_delta_from_the_float32_output(cuda):
    """The kernel takes delta = rowsum(dO * O) from the forward's float32
    output. With the weights spread over 4096 keys and k and v sharing an
    offset, dP - delta nearly cancels and dQ sums delta's error coherently;
    from the output rounded to bfloat16, dq lay ~10x further from the float32
    gradient than autograd of the plain bfloat16 forward (the arithmetic of
    the einsum form the JAX package trains through). Each gradient must lie
    within that distance (tests/test_torch_masked_attention_bwd_tiled.py holds
    the tiled arithmetic to the JAX package's bfloat16 vjp on the CPU)."""
    B, H, Q, S, D = 2, 8, 120, 4096, 32
    g = torch.Generator(device=cuda).manual_seed(13)
    q = 0.3 * torch.randn((B, H, Q, D), generator=g, device=cuda)
    k = (torch.randn((1, H, 1, D), generator=g, device=cuda)
         + torch.randn((B, H, S, D), generator=g, device=cuda))
    v = (3.0 * torch.randn((1, H, 1, D), generator=g, device=cuda)
         + torch.randn((B, H, S, D), generator=g, device=cuda))
    mask = torch.rand((B, Q, S), generator=g, device=cuda) < 0.3
    q, k, v = (t.bfloat16() for t in (q, k, v))
    out = mac.masked_attention_plain(q.float(), k.float(), v.float(), mask)
    grad_out = torch.randn((B, H, Q, D), generator=g, device=cuda)
    grad_out = (grad_out - (grad_out * out).sum(-1, keepdim=True)
                / (out * out).sum(-1, keepdim=True) * out).bfloat16()
    want = mac.masked_attention_backward_plain(grad_out.float(), q.float(), k.float(), v.float(),
                                               mask)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reference = torch.autograd.grad(mac.masked_attention_plain(*leaves, mask), leaves, grad_out)
    _, stats, out32 = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
    got = mac.masked_attn_bwd(grad_out, q, k, v, mask, out32, stats)
    for name, x, w, r in zip("qkv", got, want, reference):
        assert _rel(x, w) <= _rel(r, w), name


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
    out, stats, _ = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
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
    out, stats, _ = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
    grad_out = torch.randn_like(out)
    with pytest.raises(ValueError, match="float32 output"):
        bf = [t.bfloat16() for t in (grad_out, q, k, v)]
        mac.masked_attn_bwd(*bf, mask, out.bfloat16(), stats)
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
    _, stats, out32 = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
    want = mac.masked_attention_backward_plain(grad_out.float(), q.float(), k.float(), v.float(),
                                               mask)
    tiled = mac.masked_attention_backward_tiled(grad_out, q, k, v, mask, out32, stats)
    for chunk in (None, 64, 128, -(-S // 64) * 64):
        got = mac.masked_attn_bwd(grad_out, q, k, v, mask, out32, stats, chunk=chunk)
        for name, x, w, t in zip("qkv", got, want, tiled):
            assert x.dtype == dtype and x.shape == w.shape, name
            assert rel(x, w) <= tol, (name, chunk)
            assert rel(x, t) <= tol, (name, chunk)
        assert got[0][:, :, 0].abs().max().item() == 0
    again = mac.masked_attn_bwd(grad_out, q, k, v, mask, out32, stats)
    first = mac.masked_attn_bwd(grad_out, q, k, v, mask, out32, stats)
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
    step launches K1 12 times (6 layers, recomputed in the backward as
    TPU.REMAT_ENCODER's default says), K1 backward 6, K3 9 and K3 backward 9
    times, K2 never, and the loader hands over pinned batches."""
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
    assert cfg.TPU.REMAT_ENCODER
    assert launches == [24, 12, 18, 18, 0]
    assert pinned == [True, True]


def _released_training(device, overrides=()):
    """The released training recipe at full width with seeded weights, its
    trainer and criterion, and B = 4 seeded images of 128x128."""
    from chip_smoke import CONFIG, TRAIN_OVERRIDES, load_cfg, seeded_model
    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer

    cfg = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "SOLVER.IMS_PER_BATCH", "4", *overrides])
    batches = synthetic_batches(4, 128, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, 5, seed=0)
    trainer = Trainer(cfg, batches, model=seeded_model(torch, cfg), device=device)
    return cfg, trainer.model, trainer.criterion, next(batches).to(device)


def _counts():
    return {"msda_fwd": msda_cuda.LAUNCHES, "msda_bwd": msda_cuda.BWD_LAUNCHES,
            "masked_attn_fwd": mac.LAUNCHES, "masked_attn_bwd": mac.BWD_LAUNCHES,
            "tap_weight_fwd": tw.LAUNCHES, "tap_weight_bwd": tw.BWD_LAUNCHES}


def test_remat_on_and_off_on_the_card(cuda, monkeypatch):
    """Step 0 of the released training recipe with the encoder recomputed in
    the backward and without: K1 launches 12 and 6 times, its backward 6
    times either way; the losses within 1e-6 relative (CUDA's cross-entropy
    reduction adds in no fixed order), the gradients within 1e-5 of each
    parameter's largest entry (K1 backward's float32 atomics)."""
    from chip_smoke import loss_and_gradients

    # float32 numerics: with TF32 cuDNN picks its convolutions by the free
    # memory, which remat changes, and rounds them to 10 bits
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, model, criterion, batch = _released_training(cuda)
    encoder = model.sem_seg_head.pixel_decoder.transformer
    assert encoder.remat and encoder.remat_policy == "full"
    runs, assignments = {}, None
    for remat in (True, False):
        encoder.remat = remat
        before = _counts()
        runs[remat] = loss_and_gradients(torch, model, criterion, batch, assignments)
        assignments = runs[remat][2]  # the second run gets the first one's
        launches = {k: v - before[k] for k, v in _counts().items()}
        assert launches == {"msda_fwd": 12 if remat else 6, "msda_bwd": 6,
                            "masked_attn_fwd": 9, "masked_attn_bwd": 9, "tap_weight_fwd": 0,
                            "tap_weight_bwd": 0}
    assert runs[True][0].keys() == runs[False][0].keys()
    for k, v in runs[False][0].items():
        assert abs(runs[True][0][k] - v) <= 1e-6 * abs(v), k
    on, off = runs[True][1], runs[False][1]
    assert on.keys() == off.keys() and len(on) > 100
    for name, g in off.items():
        assert _rel(on[name], g) <= 1e-5, name


def test_accumulated_step_matches_the_plain_ops_on_the_card(cuda):
    """`TPU.GRAD_ACCUM_STEPS 2` on B = 4: step 0 through the kernels (K1 24,
    K1 backward 12, K3 and K3 backward 18 launches with remat) against the
    same step through autograd of the plain ops with the same assignments:
    losses within 1e-3 relative, gradients within 5e-3 of each parameter's
    largest entry (`chip_smoke.py`'s TRAIN_LOSS_TOL and TRAIN_GRAD_TOL)."""
    from chip_smoke import (TRAIN_EXPECTED, TRAIN_GRAD_TOL, TRAIN_LOSS_TOL, loss_and_gradients,
                            plain_ops, step_expected)

    cfg, model, criterion, batch = _released_training(cuda, ["TPU.GRAD_ACCUM_STEPS", "2"])
    before = _counts()
    k_losses, k_grads, assignments = loss_and_gradients(torch, model, criterion, batch, accum=2)
    launches = {k: v - before[k] for k, v in _counts().items()}
    assert launches == step_expected(TRAIN_EXPECTED, True, 2)
    assert len(assignments) == 2 and assignments[0].shape[1] == 2
    with plain_ops():
        p_losses, p_grads, _ = loss_and_gradients(torch, model, criterion, batch, assignments,
                                                  accum=2)
    for k, v in p_losses.items():
        assert abs(k_losses[k] - v) <= TRAIN_LOSS_TOL * max(abs(v), 1e-6), k
    assert k_grads.keys() == p_grads.keys()
    for name, g in p_grads.items():
        assert _rel(k_grads[name], g) <= TRAIN_GRAD_TOL, name


def test_msda_function_in_a_bfloat16_region(cuda):
    """K1 forward and backward inside `torch.autocast("cuda", torch.bfloat16)`
    on the types the model hands them there: value from a bfloat16 linear,
    float32 locations (float32 reference points plus bfloat16 offsets) and
    weights (CUDA autocast's float32 softmax). Both kernels launch in the
    mixed bfloat16 mode and match the plain version's float32 sampling."""
    shapes = [(12, 9), (6, 5)]
    B, Q, M, P, C = 2, 50, 4, 3, 128
    L, S = len(shapes), sum(h * w for h, w in shapes)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((B, S, C), generator=g, device=cuda)
    query = torch.randn((B, Q, C), generator=g, device=cuda)
    w_value = (torch.randn((C, C), generator=g, device=cuda) / C ** 0.5).requires_grad_()
    w_offset = (torch.randn((M * L * P * 2, C), generator=g, device=cuda) * 0.05).requires_grad_()
    w_attn = (torch.randn((M * L * P, C), generator=g, device=cuda) * 0.1).requires_grad_()
    ref = torch.rand((B, Q, 1, L, 1, 2), generator=g, device=cuda)
    normalizer = torch.tensor([[w, h] for h, w in shapes], device=cuda).view(1, 1, 1, L, 1, 2)
    grad_out = torch.randn((B, Q, M * 32), generator=g, device=cuda)

    def inputs():
        value = torch.nn.functional.linear(x, w_value).view(B, S, M, 32)
        offsets = torch.nn.functional.linear(query, w_offset).view(B, Q, M, L, P, 2)
        attn = torch.nn.functional.linear(query, w_attn).view(B, Q, M, L * P).softmax(-1)
        return value, ref + offsets / normalizer.to(offsets.dtype), attn.view(B, Q, M, L, P)

    fwd, bwd = msda_cuda.LAUNCHES, msda_cuda.BWD_LAUNCHES
    with torch.autocast("cuda", dtype=torch.bfloat16):
        value, loc, attn = inputs()
        assert (value.dtype, loc.dtype, attn.dtype) == (torch.bfloat16, torch.float32,
                                                       torch.float32)
        out = ms_deform_attn(value, shapes, loc, attn)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, (w_value, w_offset, w_attn), grad_out)
    assert (msda_cuda.LAUNCHES, msda_cuda.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        value, loc, attn = inputs()
    want_out = msda_cuda.ms_deform_attn_plain(value, shapes, loc, attn)
    assert want_out.dtype == torch.bfloat16
    assert (out.float() - want_out.float()).abs().max().item() <= TOLS[1][1]
    want = torch.autograd.grad(want_out, (w_value, w_offset, w_attn), grad_out)
    for name, a, b in zip(("value", "offsets", "weights"), got, want):
        assert a.dtype == torch.float32 and _rel(a, b) <= BWD_TOLS[1][1], name
    # the raw kernels on those types: locations and weights keep theirs
    value, loc, attn = (t.detach().contiguous() for t in (value, loc, attn))
    grads = msda_cuda.msda_bwd(grad_out.bfloat16(), value, shapes, loc, attn)
    assert [t.dtype for t in grads] == [torch.bfloat16, torch.float32, torch.float32]


def test_msda_kernels_refuse_other_type_mixes(cuda):
    shapes = [(4, 4)]
    value, loc, attn = _msda_inputs(cuda, 1, 16, 2, 32, shapes, 2)
    grad_out = torch.randn((1, 16, 64), device=cuda)
    bf = torch.bfloat16
    for args in [(value, loc.to(bf), attn.to(bf)),          # float32 value, bfloat16 sampling
                 (value.to(bf), loc, attn.to(bf)),          # locations and weights differ
                 (value.half(), loc, attn),                 # a type the kernels lack
                 (value.to(bf), loc.double(), attn.double())]:
        with pytest.raises(TypeError, match="float32"):
            msda_cuda.msda_fwd(args[0], shapes, *args[1:])
        with pytest.raises(TypeError, match="float32"):
            msda_cuda.msda_bwd(grad_out.to(args[0].dtype), args[0], shapes, *args[1:])
    with pytest.raises(TypeError, match="float32"):  # grad_out in another type than value
        msda_cuda.msda_bwd(grad_out, value.to(bf), shapes, loc, attn)


def test_masked_attention_function_in_a_bfloat16_region(cuda):
    """K3 forward and backward inside `torch.autocast("cuda", torch.bfloat16)`
    on the head views of bfloat16 projections, as `MultiheadAttention` hands
    them over: both kernels launch in bfloat16 and match the plain version."""
    B, H, Q, S, C = 2, 8, 20, 300, 256
    g = torch.Generator(device=cuda).manual_seed(10)
    tgt = torch.randn((B, Q, C), generator=g, device=cuda)
    memory = torch.randn((B, S, C), generator=g, device=cuda)
    weights = [(torch.randn((C, C), generator=g, device=cuda) / C ** 0.5).requires_grad_()
               for _ in range(3)]
    mask = torch.rand((B, Q, S), generator=g, device=cuda) < 0.6
    mask[:, 0] = True
    grad_out = torch.randn((B, H, Q, 32), generator=g, device=cuda)

    def heads():
        return [torch.nn.functional.linear(x, w).view(B, -1, H, 32).transpose(1, 2)
                for x, w in zip((tgt, memory, memory), weights)]

    fwd, bwd = mac.LAUNCHES, mac.BWD_LAUNCHES
    with torch.autocast("cuda", dtype=torch.bfloat16):
        q, k, v = heads()
        assert q.dtype == k.dtype == v.dtype == torch.bfloat16 and not q.is_contiguous()
        out = mac.masked_attention(q, k, v, mask)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, weights, grad_out)
    assert (mac.LAUNCHES, mac.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        q, k, v = heads()
    want_out = mac.masked_attention_plain(q.float(), k.float(), v.float(), mask)
    assert (out.float() - want_out).abs().max().item() <= TOLS[1][1]
    want = torch.autograd.grad(want_out, weights, grad_out)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and _rel(a, b) <= BWD_TOLS[1][1]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mac.masked_attn_fwd(q.detach(), k.detach().float(), v.detach(), mask)


# K2's backward against its plain version, relative to each gradient's largest
# entry: float32 sums d products in another order; bfloat16 rounds grad_w's
# float32 sum to 8 bits (grad_taps is one float32 product rounded, as the
# plain version rounds it)
TAP_BWD_TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)]


@pytest.mark.parametrize("dtype,tol", TAP_BWD_TOLS)
@pytest.mark.parametrize("b,q,n_points,n_heads,d,offset", [
    (1, 850, 4, 8, 32, 0),    # head-shared, 16 bytes a thread, 8 (fp32) or 4 (bf16) a group
    (8, 850, 4, 1, 32, 0),    # per-head patch tables as the batch
    (2, 101, 3, 8, 32, 0),    # ragged Q, P and Q coprime
    (3, 37, 5, 2, 6, 0),      # D = 6: one thread per (row, t, m)
    (2, 45, 4, 3, 16, 1),     # taps off their 16-byte boundary: one lane a thread
    (1, 19, 2, 2, 64, 0),     # 16 (fp32) or 8 (bf16) threads a group
    (2, 7, 1, 1, 128, 0),     # one group a warp in fp32
])
def test_tap_weighting_backward_kernel_matches_plain(cuda, dtype, tol, b, q, n_points, n_heads,
                                                     d, offset):
    taps, w = _tap_inputs(cuda, b, q, n_points, n_heads, d, dtype, seed=9)
    if offset:  # a view one element into a larger buffer
        taps = torch.cat([taps.new_zeros(1), taps.flatten()])[offset:].view(taps.shape)
    g = torch.randn((b, q, n_heads * d), device=cuda).to(dtype)
    before = tw.BWD_LAUNCHES
    got = tw.tap_weight_bwd(taps, w, g, n_points, n_heads, d)
    assert tw.BWD_LAUNCHES == before + 1
    want = tw.weight_taps_backward_plain(taps.float(), w.float(), g.float(), n_points, n_heads, d)
    for name, x, y, like in zip(("taps", "w"), got, want, (taps, w)):
        assert x.dtype == dtype and x.shape == like.shape, name
        assert _rel(x, y) <= tol, (name, _rel(x, y))
    # the group sums run in a fixed order: two calls give equal bits
    again = tw.tap_weight_bwd(taps, w, g, n_points, n_heads, d)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_tap_weighting_function_passes_gradients_and_counts_launches(cuda):
    """Through `weight_taps`: a tensor that requires a gradient goes through
    TapWeightingFunction (one forward and one backward launch), with the
    gradients of autograd of the plain version; without one, the forward
    kernel alone."""
    taps, w = _tap_inputs(cuda, 2, 53, 3, 8, 32, torch.float32, seed=10)
    g = torch.randn((2, 53, 256), device=cuda)
    leaves = [taps.clone().requires_grad_(), w.clone().requires_grad_()]
    fwd, bwd = tw.LAUNCHES, tw.BWD_LAUNCHES
    out = tw.weight_taps(leaves[0], leaves[1], 3, 8, 32)
    out.backward(g)
    assert (tw.LAUNCHES, tw.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    plain = [taps.clone().requires_grad_(), w.clone().requires_grad_()]
    want = torch.autograd.grad(tw.weight_taps_plain(plain[0], plain[1], 3, 8, 32), plain, g)
    for leaf, y in zip(leaves, want):
        assert _rel(leaf.grad, y) <= 1e-5
    # one input requiring a gradient is enough; the other gets none
    w_leaf = w.clone().requires_grad_()
    tw.weight_taps(taps, w_leaf, 3, 8, 32).backward(g)
    assert _rel(w_leaf.grad, want[1]) <= 1e-5
    assert (tw.LAUNCHES, tw.BWD_LAUNCHES) == (fwd + 2, bwd + 2)
    with torch.no_grad():
        tw.weight_taps(leaves[0], leaves[1], 3, 8, 32)
    tw.weight_taps(taps, w, 3, 8, 32)
    assert (tw.LAUNCHES, tw.BWD_LAUNCHES) == (fwd + 4, bwd + 2)


def test_tap_weighting_backward_kernel_against_finite_differences(cuda):
    """K2 is linear in taps and in w, so a central difference of the kernel
    forward along a random direction is exact up to rounding."""
    taps, w = _tap_inputs(cuda, 2, 31, 4, 8, 32, torch.float32, seed=11)
    g = torch.randn((2, 31, 256), device=cuda)
    grads = tw.tap_weight_bwd(taps, w, g, 4, 8, 32)
    gen = torch.Generator(device=cuda).manual_seed(12)
    for i, (x, eps) in enumerate(((taps, 1e-1), (w, 1e-2))):
        direction = torch.randn(x.shape, generator=gen, device=cuda)
        hi, lo = [taps, w], [taps, w]
        hi[i], lo[i] = x + eps * direction, x - eps * direction
        numeric = ((tw.tap_weight_fwd(*hi, 4, 8, 32).double()
                    - tw.tap_weight_fwd(*lo, 4, 8, 32).double()) * g.double()).sum().item()
        numeric /= 2 * eps
        analytic = (grads[i].double() * direction.double()).sum().item()
        assert abs(numeric - analytic) <= 1e-3 * max(abs(analytic), 1.0), i


def test_tap_weighting_backward_kernel_refuses_what_it_does_not_take(cuda):
    taps, w = _tap_inputs(cuda, 2, 16, 4, 2, 32, torch.float32)
    g = torch.randn((2, 16, 64), device=cuda)
    with pytest.raises(RuntimeError, match="forward-only.*weight_taps"):
        tw.tap_weight_bwd(taps.clone().requires_grad_(), w, g, 4, 2, 32)
    with pytest.raises(ValueError, match="g .* is not"):
        tw.tap_weight_bwd(taps, w, g[:, :8].contiguous(), 4, 2, 32)
    with pytest.raises(ValueError, match="contiguous"):
        tw.tap_weight_bwd(taps, w, g.transpose(0, 1).contiguous().transpose(0, 1), 4, 2, 32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tw.tap_weight_bwd(taps, w, g.bfloat16(), 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tw.tap_weight_bwd(taps, w, g.cpu(), 4, 2, 32)
    with pytest.raises(ValueError, match="w .* is not"):
        tw.tap_weight_bwd(taps, w[..., :4].contiguous(), g, 4, 2, 32)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("route", ["headshare", "per_head_tap_weighting", "per_head_16_channels"])
def test_k2_sampling_routes_train_on_the_card(cuda, dtype, tol, route):
    """The gradients in value, locations and attention weights of both K2
    routes on the card (K2 forward and backward, `index_select`'s
    scatter-add) against the same function on the CPU (the plain version
    and autograd), relative to each gradient's largest entry. Locations are
    kept 0.01 pixel from pixel borders, where the locations' gradient jumps.
    bfloat16: the taps, the folded weights, each level's sum and the
    gradients are rounded to 8 bits. `per_head_16_channels`: per-head
    sampling with heads of 16 channels (the frozen synthetic recipe's), which
    K1 does not take, goes through the patch-table route unasked."""
    shapes = [(25, 34), (13, 17), (7, 9)]
    S = sum(h * w for h, w in shapes)
    D = 16 if route == "per_head_16_channels" else 32
    value, loc, attn = _msda_inputs(cuda, 2, S, 8, D, shapes, 4, seed=13)
    sizes = torch.tensor([[w, h] for h, w in shapes], device=cuda).view(1, 1, 1, 3, 1, 2)
    pix = loc * sizes - 0.5
    loc = (pix.floor() + (pix - pix.floor()).clamp(1e-2, 1 - 1e-2) + 0.5) / sizes
    if route == "headshare":
        loc = loc[:, :, 0].contiguous()

        def fn(v, lo, a):
            return ms_deform_attn_headshare(v, shapes, lo, a)
    else:
        def fn(v, lo, a):
            return ms_deform_attn(v, shapes, lo, a, pallas_weighting=D == 32)
    grad_out = torch.randn((2, S, 8 * D), device=cuda)
    leaves = [value.to(dtype).requires_grad_(), loc.clone().requires_grad_(),
              attn.clone().requires_grad_()]
    fwd, bwd, k1 = tw.LAUNCHES, tw.BWD_LAUNCHES, msda_cuda.LAUNCHES
    fn(*leaves).backward(grad_out.to(dtype))
    assert (tw.LAUNCHES, tw.BWD_LAUNCHES, msda_cuda.LAUNCHES) == (fwd + 3, bwd + 3, k1)
    cpu = [t.detach().cpu().float().requires_grad_() for t in (value, loc, attn)]
    want = torch.autograd.grad(fn(*cpu), cpu, grad_out.cpu())
    for name, leaf, y in zip(("value", "locations", "weights"), leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        assert _rel(leaf.grad.cpu(), y) <= tol, (name, _rel(leaf.grad.cpu(), y))


# K1 backward on locations that load its adds in other ways: four levels of
# one size, every point 30 pixels off its token, every point of a level on one
# pixel (all adds of a level on one row), Q != S, and the released batch's
# launch (B = 16, 1024x1024, M = 8).
def _bwd_case(device, case, B=2, M=4, P=4):
    from mp_former_tpu_torch.models.pixel_decoder.msdeformattn import _reference_points

    shapes = {"four_levels": [(32, 32)] * 4, "bs16": [(32, 32), (64, 64), (128, 128)]}.get(
        case, [(64, 64), (32, 32), (16, 16)])
    B = 16 if case == "bs16" else B
    M = 8 if case == "bs16" else M
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value, loc, attn = _msda_inputs(device, B, S, M, 32, shapes, P, seed=21)
    g = torch.Generator(device=device).manual_seed(22)
    sizes = torch.tensor([[w, h] for h, w in shapes], device=device).view(1, 1, 1, L, 1, 2)
    ref = _reference_points(shapes, device)[None, :, None, :, None, :]
    if case == "all_outside":     # points 30 pixels on either side of their token
        sign = torch.tensor([1.0, -1.0], device=device).repeat(P // 2).view(1, 1, 1, 1, P, 1)
        loc = (ref + sign * 30 / sizes).expand(B, S, M, L, P, 2).contiguous()
    elif case == "one_pixel":     # every point of a level on its middle pixel
        loc = torch.tensor([[(w // 2 + 0.5) / w, (h // 2 + 0.5) / h] for h, w in shapes],
                           device=device).view(1, 1, 1, L, 1, 2).expand(B, S, M, L, P, 2)
        loc = loc.contiguous()
    elif case != "q_not_s":       # a few pixels off the tokens, 2% far off the map
        loc = ref + torch.randn((B, S, M, L, P, 2), generator=g, device=device) * 3.0 / sizes
        far = torch.rand((B, S, M, L, P, 1), generator=g, device=device) < 0.02
        loc = torch.where(far, loc + 2.0, loc)
    if case == "q_not_s":         # one query short of the tokens
        loc, attn = loc[:, 1:].contiguous(), attn[:, 1:].contiguous()
    grad_out = torch.randn((B, loc.shape[1], M * 32), generator=g, device=device)
    return shapes, value, loc, attn, grad_out


@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("case", ["four_levels", "all_outside", "one_pixel", "q_not_s", "bs16"])
def test_msda_backward_kernel_on_hard_locations(cuda, case, mix):
    """float32, and the bfloat16 model's mix (bfloat16 value and gradient,
    float32 locations and weights) at bfloat16's tolerance."""
    shapes, value, loc, attn, grad_out = _bwd_case(cuda, case)
    want = msda_cuda.ms_deform_attn_backward_plain(grad_out, value, shapes, loc, attn)
    if mix:
        grad_out, value = grad_out.bfloat16(), value.bfloat16()
    got = msda_cuda.msda_bwd(grad_out, value, shapes, loc, attn)
    tol = 1e-2 if mix else 1e-4
    for name, x, w in zip(("value", "loc", "attn"), got, want):
        assert torch.isfinite(x).all(), name
        if name == "loc":  # a point may round to the other side of a pixel border
            assert ((x.float() - w).abs() > tol * w.abs().max()).float().mean() <= 1e-5
        else:
            assert _rel(x, w) <= tol, name
    del want


def test_msda_backward_kernel_two_calls_equal_to_rounding(cuda):
    """grad_attn and grad_loc are written once each: equal bits; grad_value
    sums in float32 atomics in no fixed order: equal to rounding."""
    shapes, value, loc, attn, grad_out = _bwd_case(cuda, "noisy")
    first = msda_cuda.msda_bwd(grad_out, value, shapes, loc, attn)
    again = msda_cuda.msda_bwd(grad_out, value, shapes, loc, attn)
    assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
    assert _rel(first[0], again[0]) <= 1e-6
