"""Masked cross-attention: the CUDA kernel K3 and its plain versions.

`masked_attn_fwd` launches `csrc/masked_attn_fwd.cu` (the port of the TPU
kernel `mp_former_tpu/ops/fused_masked_attention.py:masked_attention`);
`masked_attention_plain` is the same function in plain PyTorch, the XLA path
of `mp_former_tpu/models/transformer_decoder/primitives.py:72-80`.
`masked_attn_bwd` launches `csrc/masked_attn_bwd.cu`, the gradients with
respect to q, k and v recomputed flash-style from the row statistics the
forward writes on request (the TPU kernel has no gradient: the JAX package
trains through the einsum form); `masked_attention_backward_plain` is the same
on tensors, without autograd. `MaskedAttentionFunction` joins the two kernels
for autograd. `masked_attention` dispatches: CUDA tensors to the kernels, CPU
tensors to the plain version. `masked_attention_tiled` and
`masked_attention_backward_tiled` repeat the two kernels' arithmetic (their
tiles, their split over the keys, their 3xTF32 products and bfloat16
roundings) in plain PyTorch, for the tests and `chip_smoke.py` only.

    softmax(q kᵀ / √D, masked logits = -1e9) v

q (B, H, Q, D); k, v (B, H, S, D); mask bool (True = blocked), either
(B, Q, S) shared by all heads (the decoder's masks are identical across
heads, `mask2former_decoder.py:327-328`) or (B, H, Q, S). A masked logit is
-1e9, not -inf, so a row with every key masked is uniform, not NaN.

Layouts the kernel takes: q, k and v are logical (B, H, N, D) with any batch,
head and row stride, as long as the last dimension is contiguous and every
row starts on a 16-byte boundary, so the (B, N, H, D) projection of
`MultiheadAttention` goes in as a transposed view, without a copy. The mask
is contiguous, at any alignment. The result is logical (B, H, Q, D) and lies
in memory as (B, Q, H, D): `out.transpose(1, 2).reshape(B, Q, H * D)` is a view.
"""

from __future__ import annotations

import math

import torch

from .cuda_build import DTYPE_CODES, check_inputs, launch, sm_count

# launches of the forward since the last reset (one per call: the tile kernel
# and, where the keys are split, the merge kernel together), and of the
# backward (one per call: its key kernel and, where the keys are split, its
# merge kernel together)
LAUNCHES = 0
BWD_LAUNCHES = 0

_NEG_INF = -1e9
_LOG2E = 1.4426950408889634
QUERY_TILE = 16       # query rows of a warp
KEY_TILE = 64         # keys of a shared-memory tile; a chunk is whole tiles
KEY_STEP = 32         # keys of one step of the online softmax: half a tile
BLOCK_QUERIES = 128   # query rows of a block: 8 warps
BLOCKS_PER_SM = 2     # what the split over the keys aims for
BWD_KEY_TILE = 64     # keys of a backward block's tile: 16 a warp
BWD_QUERY_TILE = 32   # query rows of a backward step
BWD_MAX_ROWS = 256    # query rows of a backward block
BWD_BLOCKS_PER_SM = 2


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """einsum + masked_fill(-1e9) + softmax + einsum."""
    logits = torch.einsum("bhqd,bhsd->bhqs", q, k) / math.sqrt(q.shape[-1])
    m = mask[:, None] if mask.dim() == 3 else mask
    attn = logits.masked_fill(m, _NEG_INF).softmax(dim=-1)
    return torch.einsum("bhqs,bhsd->bhqd", attn, v)


def masked_attention_backward_plain(grad_out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, mask: torch.Tensor,
                                    out: torch.Tensor | None = None):
    """The gradients of `masked_attention_plain` with respect to q, k and v,
    written out on tensors (no autograd), in the backward kernel's arithmetic:
    p = softmax of the logits with the blocked ones REPLACED by -1e9, delta =
    rowsum(dO * O), dV = p^T dO, dS = p * (dO v^T - delta) and 0 where the mask
    blocks (the -1e9 is a constant) or in a row where one key carries all of
    the weight (its weight is 1: delta is that key's dP), dQ = dS k /
    sqrt(D), dK = dS^T q / sqrt(D). A row blocked everywhere is uniform over
    all keys: dV gets dO / S from it, dQ and dK nothing. delta is taken in float32 (float64 for
    float64 inputs) from O recomputed here in that type, or from `out`, the
    forward's output as the kernel is handed it (its float32 copy, before the
    rounding to bfloat16): where the weights are spread over many keys, dP -
    delta cancels, and an O rounded to bfloat16 moves every dS of a row alike,
    which dQ sums coherently."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    m = mask[:, None] if mask.dim() == 3 else mask
    m = m.bool()
    logits = torch.einsum("bhqd,bhsd->bhqs", q, k) * scale
    p = logits.masked_fill(m, _NEG_INF).softmax(dim=-1)
    acc = torch.promote_types(grad_out.dtype, torch.float32)
    if out is None:
        out = torch.einsum("bhqs,bhsd->bhqd", p.to(acc), v.to(acc))
    delta = (grad_out.to(acc) * out.to(acc)).sum(-1, keepdim=True)
    d_v = torch.einsum("bhqs,bhqd->bhsd", p, grad_out)
    d_p = torch.einsum("bhqd,bhsd->bhqs", grad_out, v)
    one_key = p.amax(-1, keepdim=True) == 1
    d_s = (p * (d_p - delta).to(p.dtype)).masked_fill(m | one_key, 0.0)
    d_q = torch.einsum("bhqs,bhsd->bhqd", d_s, k) * scale
    d_k = torch.einsum("bhqs,bhqd->bhsd", d_s, q) * scale
    return d_q, d_k, d_v


def _chunk_size(S: int, parallel_blocks: int, sms: int) -> int:
    """Keys per block: split S so that, with `parallel_blocks` blocks per
    key chunk (one per batch entry, head and 128 query rows), the grid holds
    about BLOCKS_PER_SM blocks per SM; whole 64-key tiles, at least one."""
    tiles = -(-S // KEY_TILE)
    chunks = min(tiles, max(1, -(-BLOCKS_PER_SM * sms // parallel_blocks)))
    return -(-tiles // chunks) * KEY_TILE


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 bits of mantissa, to nearest, ties away
    from zero (`cvt.rna.tf32.f32`)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum(eq, a, b) as the kernel's tensor cores do it in float32: each
    operand split into big = tf32(x) and small = tf32(x - big), the products
    small x big and big x small added first, then big x big, in float32; the
    small x small term (2^-22 relative) is left out."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return ((torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small))
            + torch.einsum(eq, a_big, b_big))


def masked_attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, chunk: int | None = None,
                           sms: int = 132, with_stats: bool = False):
    """The kernel's arithmetic in plain PyTorch: query rows padded to 16-row
    tiles, the keys split into chunks of `chunk` (by default the wrapper's
    choice for a card of `sms` SMs), each chunk walked in 32-key steps with an
    online softmax in the base-2 domain (a masked key scores -1e9 log2 e, a
    key beyond the end of S -inf and its value row is zero), float32 products
    as 3xTF32 and bfloat16 products with the weights rounded to bfloat16, and
    the chunks merged by their maxima. `with_stats` also returns the (B, H, Q,
    2) row statistics the kernel writes for the backward and the output in
    float32, before its rounding to the input type: (out, stats, out32). Not
    on any main path:
    the tests hold it against the plain version and the JAX function,
    `chip_smoke.py` holds the kernel against it."""
    B, H, Q, D = q.shape
    S = k.shape[2]
    if chunk is None:
        chunk = _chunk_size(S, B * H * -(-Q // BLOCK_QUERIES), sms)
    if chunk <= 0 or chunk % KEY_TILE:
        raise ValueError(f"masked_attention_tiled: chunk {chunk} is no multiple of {KEY_TILE}")
    single = q.dtype == torch.float32
    scale = _LOG2E / math.sqrt(D)
    masked = _NEG_INF * _LOG2E
    rows = -(-Q // QUERY_TILE) * QUERY_TILE
    qp = q.new_zeros((B, H, rows, D))
    qp[:, :, :Q] = q
    blocked = torch.zeros((B, H, rows, S), dtype=torch.bool, device=q.device)
    blocked[:, :, :Q] = (mask[:, None] if mask.dim() == 3 else mask).bool()
    qp = qp * scale if single else qp.float()

    def tile_of(x, t0, n):
        tile = x.new_zeros((B, H, KEY_STEP, D))
        tile[:, :, :n] = x[:, :, t0:t0 + n]
        return tile if single else tile.float()

    parts = []
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        m = q.new_full((B, H, rows), -1e30, dtype=torch.float32)
        l = torch.zeros_like(m)
        o = q.new_zeros((B, H, rows, D), dtype=torch.float32)
        for t0 in range(s0, s1, KEY_STEP):
            n = min(KEY_STEP, s1 - t0)
            kt, vt = tile_of(k, t0, n), tile_of(v, t0, n)
            if single:
                s = _product_3xtf32("bhqd,bhsd->bhqs", qp, kt)
            else:
                s = torch.einsum("bhqd,bhsd->bhqs", qp, kt) * scale
            s[..., :n] = s[..., :n].masked_fill(blocked[..., t0:t0 + n], masked)
            s[..., n:] = -math.inf
            new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - new)
            p = torch.exp2(s - new[..., None])
            l = l * alpha + p.sum(-1)
            if single:
                pv = _product_3xtf32("bhqs,bhsd->bhqd", p, vt)
            else:
                pv = torch.einsum("bhqs,bhsd->bhqd", p.bfloat16().float(), vt)
            o = o * alpha[..., None] + pv
            m = new
        parts.append((m, l, o))
    if len(parts) == 1:
        m_all, l_all = m, l
        out = o / l[..., None]
    else:
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        weights = [torch.exp2(m - m_all) for m, _, _ in parts]
        l_all = sum(l * w for (_, l, _), w in zip(parts, weights))
        out = sum(o * w[..., None] for (_, _, o), w in zip(parts, weights)) / l_all[..., None]
    out32 = out[:, :, :Q]
    out = out32.to(q.dtype)
    if with_stats:
        return out, torch.stack([m_all, l_all], -1)[:, :, :Q].contiguous(), out32
    return out


def masked_attention_backward_tiled(grad_out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, mask: torch.Tensor, out: torch.Tensor,
                                    stats: torch.Tensor, chunk: int | None = None,
                                    sms: int = 132):
    """The backward kernel's arithmetic in plain PyTorch, for the stats and the
    float32 output (out32) of the forward: per chunk of keys (by default the wrapper's choice for a
    card of `sms` SMs) and 64-key tile, the queries in 32-row tiles; delta =
    dO . O in float32; S^T = (k log2(e) / sqrt(D)) q^T and dP^T = v dO^T, P = 2^(S
    - max) / sum (a blocked score is -1e9 log2 e, a key beyond S weighs 0), dS =
    P (dP - delta) and 0 where blocked or where the row's sum is 1 (one key
    carries all of its weight); float32 products as 3xTF32, bfloat16
    products with P and dS rounded to bfloat16; dV += P^T dO and dK += dS^T q
    per tile; dQ summed over a chunk's tiles, then over the chunks in order,
    and scaled by 1 / sqrt(D) last. Returns (dq, dk, dv) in the input type,
    logical (B, H, N, D). Not on any main path: the tests hold it against the
    plain backward and the JAX function's vjp, `chip_smoke.py` holds the kernel
    against it."""
    B, H, Q, D = q.shape
    S = k.shape[2]
    if chunk is None:
        chunk = _bwd_chunk_size(S, B * H * -(-Q // BWD_MAX_ROWS), sms)
    if chunk <= 0 or chunk % BWD_KEY_TILE:
        raise ValueError(f"masked_attention_backward_tiled: chunk {chunk} is no multiple of "
                         f"{BWD_KEY_TILE}")
    if out.dtype != torch.float32:
        raise ValueError("masked_attention_backward_tiled: out must be the forward's float32 "
                         f"output, got {out.dtype}")
    single = q.dtype == torch.float32
    scale = 1.0 / math.sqrt(D)
    rows = -(-Q // BWD_QUERY_TILE) * BWD_QUERY_TILE

    def padded(x, n):
        y = x.new_zeros((B, H, n, D))
        y[:, :, :x.shape[2]] = x
        return y.float()

    def product(eq, a, b):
        if single:
            return _product_3xtf32(eq, a, b)
        return torch.einsum(eq, a.bfloat16().float(), b.bfloat16().float())

    qp, gp = padded(q, rows), padded(grad_out, rows)
    delta = (padded(out, rows) * gp).sum(-1)                          # (B, H, rows)
    m = q.new_zeros((B, H, rows), dtype=torch.float32)
    inv_l = torch.zeros_like(m)
    m[:, :, :Q] = stats[..., 0]
    inv_l[:, :, :Q] = 1.0 / stats[..., 1]
    blocked = torch.zeros((B, H, rows, S), dtype=torch.bool, device=q.device)
    blocked[:, :, :Q] = (mask[:, None] if mask.dim() == 3 else mask).bool()
    dq_parts = []
    dk = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for s0 in range(0, S, chunk):
        dq_chunk = torch.zeros((B, H, rows, D), dtype=torch.float32, device=q.device)
        for t0 in range(s0, min(S, s0 + chunk), BWD_KEY_TILE):
            n = min(BWD_KEY_TILE, S - t0, s0 + chunk - t0)
            kt, vt = padded(k[:, :, t0:t0 + n], BWD_KEY_TILE), padded(v[:, :, t0:t0 + n],
                                                                       BWD_KEY_TILE)
            ks = kt * (_LOG2E * scale) if single else kt
            for r0 in range(0, rows, BWD_QUERY_TILE):
                r1 = r0 + BWD_QUERY_TILE
                s = product("bkd,bqd->bkq", ks.flatten(0, 1), qp[:, :, r0:r1].flatten(0, 1))
                s = s.view(B, H, BWD_KEY_TILE, BWD_QUERY_TILE)
                if not single:
                    s = s * (_LOG2E * scale)
                dp = product("bkd,bqd->bkq", vt.flatten(0, 1), gp[:, :, r0:r1].flatten(0, 1))
                dp = dp.view(B, H, BWD_KEY_TILE, BWD_QUERY_TILE)
                blk = torch.zeros((B, H, BWD_KEY_TILE, BWD_QUERY_TILE), dtype=torch.bool,
                                  device=q.device)
                blk[:, :, :n] = blocked[:, :, r0:r1, t0:t0 + n].transpose(2, 3)
                s = s.masked_fill(blk, _NEG_INF * _LOG2E)
                p = torch.exp2(s - m[:, :, None, r0:r1]) * inv_l[:, :, None, r0:r1]
                p[:, :, n:] = 0.0
                ds = (p * (dp - delta[:, :, None, r0:r1])).masked_fill(blk, 0.0)
                ds = ds.masked_fill((inv_l[:, :, None, r0:r1] == 1.0), 0.0)  # one key: dS 0
                ds[:, :, n:] = 0.0
                dv[:, :, t0:t0 + n] += product("bkq,bqd->bkd", p.flatten(0, 1),
                                               gp[:, :, r0:r1].flatten(0, 1)).view(
                                                   B, H, BWD_KEY_TILE, D)[:, :, :n]
                dk[:, :, t0:t0 + n] += product("bkq,bqd->bkd", ds.flatten(0, 1),
                                               qp[:, :, r0:r1].flatten(0, 1)).view(
                                                   B, H, BWD_KEY_TILE, D)[:, :, :n]
                dq_chunk[:, :, r0:r1] += product("bkq,bkd->bqd", ds.flatten(0, 1),
                                                 kt.flatten(0, 1)).view(
                                                     B, H, BWD_QUERY_TILE, D)
        dq_parts.append(dq_chunk)
    dq = dq_parts[0]
    for part in dq_parts[1:]:
        dq = dq + part
    return ((dq[:, :, :Q] * scale).to(q.dtype), (dk * scale).to(q.dtype), dv.to(q.dtype))


def _check_attention(name: str, q, k, v, mask, more=()):
    """The rules both kernels share for q, k, v (and `more` tensors shaped like
    q) and the mask; returns the device, (B, H, Q, S, D) and the mask's batch
    and head strides."""
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{name}: mask must be bool or uint8, got {mask.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k must be (B, H, N, D), got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    device = check_inputs(name, (q, k, v, *more), tuple(DTYPE_CODES), others=(mask,),
                          align=16, strided=3 + len(more))
    B, H, Q, D = q.shape
    S = k.shape[2]
    if D != 32:
        raise ValueError(f"{name}: the kernel takes 32 channels per head, got {D}")
    if k.shape != (B, H, S, D) or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    for t in more:
        if t.shape != q.shape:
            raise ValueError(f"{name}: a tensor of shape {tuple(t.shape)} where q's "
                             f"{tuple(q.shape)} is expected")
    if mask.shape == (B, Q, S):
        mask_sb, mask_sh = Q * S, 0
    elif mask.shape == (B, H, Q, S):
        mask_sb, mask_sh = H * Q * S, Q * S
    else:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} is neither "
                         f"{(B, Q, S)} nor {(B, H, Q, S)}")
    if S == 0:
        raise ValueError(f"{name}: no keys")
    return device, (B, H, Q, S, D), (mask_sb, mask_sh)


def masked_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, chunk: int | None = None, with_stats: bool = False):
    """Launch K3 on CUDA tensors (forward only); raises on anything it does
    not take, and if a launch fails. `chunk` is the number of keys a block
    walks, a multiple of 64; by default chosen from the shape and the card's
    SM count. `with_stats` returns (out, stats, out32): also the (B, H, Q, 2)
    float32 row statistics the backward kernel needs (each row's maximum score
    in the kernel's base-2 domain and the sum of its weights relative to it)
    and the output in float32, from which the backward takes delta (out itself
    in float32; in bfloat16 a float32 copy the kernel writes before rounding,
    with out's strides); serving does not ask."""
    global LAUNCHES
    device, (B, H, Q, S, D), (mask_sb, mask_sh) = _check_attention("masked_attn_fwd", q, k, v,
                                                                   mask)
    if chunk is None:
        chunk = _chunk_size(S, B * H * -(-Q // BLOCK_QUERIES), sm_count(device.index))
    elif chunk <= 0 or chunk % KEY_TILE:
        raise ValueError(f"masked_attn_fwd: chunk {chunk} is no multiple of {KEY_TILE}")
    chunks = -(-S // chunk)
    # (B, Q, H, D) in memory, so the caller's merge of the heads is a view
    out = torch.empty_strided((B, H, Q, D), (Q * H * D, D, H * D, 1), dtype=q.dtype,
                              device=device)
    # the chunks' accumulators, maxima and sums, in one piece
    part = (torch.empty((B * H * chunks * Q * (D + 2),), dtype=torch.float32, device=device)
            if chunks > 1 else None)
    stats = (torch.empty((B, H, Q, 2), dtype=torch.float32, device=device)
             if with_stats else None)
    out32 = out
    if with_stats and q.dtype != torch.float32:
        out32 = torch.empty_strided(out.shape, out.stride(), dtype=torch.float32, device=device)
    launch("masked_attn_fwd", device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
           None if part is None else part.data_ptr(), out.data_ptr(),
           None if stats is None else stats.data_ptr(),
           out32.data_ptr() if out32 is not out else None,
           B, H, Q, S, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           Q * H * D, D, H * D, mask_sb, mask_sh, chunk, DTYPE_CODES[q.dtype])
    LAUNCHES += 1
    return (out, stats, out32) if with_stats else out


def _bwd_chunk_size(S: int, parallel_blocks: int, sms: int) -> int:
    """Keys per block of the backward: whole 64-key tiles, S split so that,
    with `parallel_blocks` blocks per chunk (one per batch entry, head and 256
    query rows), the grid holds at most BWD_BLOCKS_PER_SM blocks per SM (the
    blocks that fit at once): one more block would start a second wave of
    blocks, each as long as the first."""
    tiles = -(-S // BWD_KEY_TILE)
    chunks = min(tiles, max(1, BWD_BLOCKS_PER_SM * sms // parallel_blocks))
    return -(-tiles // chunks) * BWD_KEY_TILE


def masked_attn_bwd(grad_out: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, out: torch.Tensor, stats: torch.Tensor,
                    chunk: int | None = None):
    """Launch K3's backward on CUDA tensors: (dq, dk, dv) for the `stats` and
    the float32 `out` (out32) that `masked_attn_fwd(..., with_stats=True)`
    returned on the same q, k, v and mask. The gradients are logical (B, H, N, D) and lie in memory
    as (B, N, H, D), like the projections they belong to. `chunk`: the keys a
    block walks, a multiple of 64, by default chosen from the shape and the
    card's SM count. Where the keys are split, each block writes its dq into a
    scratch that a second kernel sums in chunk order: the result is the same
    bit for bit from run to run. Raises on anything the kernel does not take,
    and if a launch fails."""
    global BWD_LAUNCHES
    strides = grad_out.stride()
    if strides[-1] != 1 or any(st * grad_out.element_size() % 16 for st in strides[:-1]):
        grad_out = grad_out.contiguous()
    device, (B, H, Q, S, D), (mask_sb, mask_sh) = _check_attention(
        "masked_attn_bwd", q, k, v, mask, more=(grad_out,))
    if out.dtype != torch.float32:
        raise ValueError("masked_attn_bwd: out must be the forward's float32 output (the third "
                         f"result of masked_attn_fwd(..., with_stats=True)), got {out.dtype}")
    check_inputs("masked_attn_bwd", (out,), (torch.float32,), align=16, strided=1)
    if out.shape != q.shape or out.device != device:
        raise ValueError(f"masked_attn_bwd: out {tuple(out.shape)} on {out.device} does not "
                         f"match q {tuple(q.shape)} on {device}")
    if stats.shape != (B, H, Q, 2) or stats.dtype != torch.float32 or not stats.is_contiguous() \
            or stats.device != device:
        raise ValueError(f"masked_attn_bwd: stats must be the forward's contiguous float32 "
                         f"{(B, H, Q, 2)} on {device}, got {tuple(stats.shape)} {stats.dtype}")
    if chunk is None:
        chunk = _bwd_chunk_size(S, B * H * -(-Q // BWD_MAX_ROWS), sm_count(device.index))
    elif chunk <= 0 or chunk % BWD_KEY_TILE:
        raise ValueError(f"masked_attn_bwd: chunk {chunk} is no multiple of {BWD_KEY_TILE}")
    chunks = -(-S // chunk)
    dq = torch.empty((B, Q, H, D), dtype=q.dtype, device=device)
    # above BWD_MAX_ROWS queries the row blocks add their shares of dk and dv
    added = Q > BWD_MAX_ROWS
    dk = (torch.zeros if added else torch.empty)((B, S, H, D), device=device,
                                                 dtype=torch.float32 if added else q.dtype)
    dv = torch.zeros_like(dk) if added else torch.empty_like(dk)
    part = (torch.empty((chunks * B * H * Q * D,), dtype=torch.float32, device=device)
            if chunks > 1 else None)
    launch("masked_attn_bwd", device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
           mask.data_ptr(), stats.data_ptr(), None if part is None else part.data_ptr(),
           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Q, S, D, *q.stride()[:3],
           *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *grad_out.stride()[:3],
           mask_sb, mask_sh, chunk, DTYPE_CODES[q.dtype])
    BWD_LAUNCHES += 1
    return dq.transpose(1, 2), dk.to(q.dtype).transpose(1, 2), dv.to(q.dtype).transpose(1, 2)


class MaskedAttentionFunction(torch.autograd.Function):
    """K3 with its gradient: `masked_attn_fwd` forward (with the row
    statistics and the float32 output), `masked_attn_bwd` backward, on CUDA
    tensors. apply(q, k, v, mask)."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        q, k, v = q.detach(), k.detach(), v.detach()
        out, stats, out32 = masked_attn_fwd(q, k, v, mask, with_stats=True)
        ctx.save_for_backward(q, k, v, mask, out32, stats)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v, mask, out32, stats = ctx.saved_tensors
        # in float32 the saved output is the graph's own tensor: the kernel takes it detached
        dq, dk, dv = masked_attn_bwd(grad_out, q, k, v, mask, out32.detach(), stats)
        return dq, dk, dv, None


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """K3 for CUDA tensors (with its backward kernel where a gradient is asked
    for), the plain version for CPU tensors."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return MaskedAttentionFunction.apply(q, k, v, mask)
        return masked_attn_fwd(q, k, v, mask)
    return masked_attention_plain(q, k, v, mask)
