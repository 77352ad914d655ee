"""Masked cross-attention: the CUDA kernel K3 and its plain version.

`masked_attn_fwd` launches `csrc/masked_attn_fwd.cu` (the port of the TPU
kernel `mp_former_tpu/ops/fused_masked_attention.py:masked_attention`);
`masked_attention_plain` is the same function in plain PyTorch, the XLA path
of `mp_former_tpu/models/transformer_decoder/primitives.py:72-80`.
`masked_attention` dispatches: CUDA tensors to the kernel, CPU tensors to the
plain version.

    softmax(q kᵀ / √D, masked logits = -1e9) v

q (B, H, Q, D); k, v (B, H, S, D); mask bool (True = blocked), either
(B, Q, S) shared by all heads (the decoder's masks are identical across
heads, `mask2former_decoder.py:327-328`) or (B, H, Q, S). A masked logit is
-1e9, not -inf, so a row with every key masked is uniform, not NaN.
"""

from __future__ import annotations

import math

import torch

from .cuda_build import DTYPE_CODES, check_inputs, launch

# launches of the kernel since the last reset (one per call: the partial
# and the merge kernel together)
LAUNCHES = 0

_NEG_INF = -1e9


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """einsum + masked_fill(-1e9) + softmax + einsum."""
    logits = torch.einsum("bhqd,bhsd->bhqs", q, k) / math.sqrt(q.shape[-1])
    m = mask[:, None] if mask.dim() == 3 else mask
    attn = logits.masked_fill(m, _NEG_INF).softmax(dim=-1)
    return torch.einsum("bhqs,bhsd->bhqd", attn, v)


def _chunk_size(S: int, parallel_blocks: int, device: torch.device) -> int:
    """Keys per block: split S so that, with `parallel_blocks` blocks per
    key chunk (one per head and query tile), the grid holds about two
    blocks per SM; whole 32-key tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = max(1, -(-2 * sms // parallel_blocks))
    per_chunk = -(-S // chunks)
    return -(-per_chunk // 32) * 32


def masked_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Launch K3 on CUDA tensors (forward only); raises on anything it does
    not take, and if a launch fails."""
    global LAUNCHES
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"masked_attn_fwd: mask must be bool or uint8, got {mask.dtype}")
    device = check_inputs("masked_attn_fwd", (q, k, v), tuple(DTYPE_CODES), others=(mask,))
    B, H, Q, D = q.shape
    S = k.shape[2]
    if D != 32:
        raise ValueError(f"masked_attn_fwd: the kernel takes 32 channels per head, got {D}")
    if k.shape != (B, H, S, D) or v.shape != k.shape:
        raise ValueError(f"masked_attn_fwd: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if mask.shape == (B, Q, S):
        mask_sb, mask_sh = Q * S, 0
    elif mask.shape == (B, H, Q, S):
        mask_sb, mask_sh = H * Q * S, Q * S
    else:
        raise ValueError(f"masked_attn_fwd: mask {tuple(mask.shape)} is neither "
                         f"{(B, Q, S)} nor {(B, H, Q, S)}")
    if S == 0:
        raise ValueError("masked_attn_fwd: no keys")
    chunk = _chunk_size(S, B * H * -(-Q // 128), q.device)
    chunks = -(-S // chunk)
    part_acc = torch.empty((B * H, chunks, Q, D), dtype=torch.float32, device=q.device)
    part_m = torch.empty((B * H, chunks, Q), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    out = torch.empty_like(q)
    launch("masked_attn_fwd", device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
           part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(),
           B, H, Q, S, D, mask_sb, mask_sh, chunk, DTYPE_CODES[q.dtype])
    LAUNCHES += 1
    return out


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """K3 for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return masked_attn_fwd(q, k, v, mask)
    return masked_attention_plain(q, k, v, mask)
