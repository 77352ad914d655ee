"""Tap weighting: the CUDA kernel K2 and its plain version.

The head-shared sampling engine gathers rows that carry the 2x2 bilinear
taps of all M heads for one (query, point), and the per-head 2x2-patch engine
gathers rows with the taps of one head; both then reduce them with
per-(point, tap, head) weights:

    out[b, q, (m d)] = sum over p, t of taps[b, (p q), (t m d)] * w[b, (p q), (t m)]

`weight_taps` is the counterpart of `mp_former_tpu/ops/tap_weighting.py:
weight_taps`: CUDA tensors launch `csrc/tap_weight_fwd.cu` (the port of the
TPU kernels `_call_one` / `_call_batched`), CPU tensors take
`weight_taps_plain` (the JAX package's `weight_taps_reference`).

Rows are point-major ((p, q) order), lanes (t, m, d) major to minor.
"""

from __future__ import annotations

import torch

from .cuda_build import DTYPE_CODES, library

# launches of the kernel since the last reset
LAUNCHES = 0


def weight_taps_plain(taps: torch.Tensor, w: torch.Tensor, n_points: int, n_heads: int,
                      d: int) -> torch.Tensor:
    """taps (B, P*Q, T*M*D), w (B, P*Q, T*M) -> (B, Q, M*D) in taps.dtype."""
    b, pq, tmd = taps.shape
    q = pq // n_points
    t = tmd // (n_heads * d)
    wt = (taps.reshape(b, n_points, q, t, n_heads, d)
          * w.reshape(b, n_points, q, t, n_heads, 1).to(taps.dtype))
    return wt.sum(dim=(1, 3)).reshape(b, q, n_heads * d)


def _check_shapes(taps: torch.Tensor, w: torch.Tensor, n_points: int, n_heads: int, d: int):
    if taps.dim() != 3 or w.dim() != 3:
        raise ValueError(f"weight_taps: taps and w must be 3-D, got {tuple(taps.shape)} "
                         f"and {tuple(w.shape)}")
    b, pq, tmd = taps.shape
    if n_points <= 0 or n_heads <= 0 or d <= 0 or pq % n_points or tmd % (n_heads * d):
        raise ValueError(f"weight_taps: taps {tuple(taps.shape)} is not (B, P*Q, T*M*D) for "
                         f"P={n_points}, M={n_heads}, D={d}")
    t = tmd // (n_heads * d)
    if w.shape != (b, pq, t * n_heads):
        raise ValueError(f"weight_taps: w {tuple(w.shape)} is not {(b, pq, t * n_heads)}")
    return b, pq // n_points, t


def tap_weight_fwd(taps: torch.Tensor, w: torch.Tensor, n_points: int, n_heads: int,
                   d: int) -> torch.Tensor:
    """Launch K2 on CUDA tensors (forward only); raises on anything it does
    not take, and if the launch fails."""
    global LAUNCHES
    if not (taps.is_cuda and w.is_cuda and taps.device == w.device):
        raise ValueError("tap_weight_fwd: taps and w must be CUDA tensors on one device")
    if taps.dtype not in DTYPE_CODES or w.dtype != taps.dtype:
        raise TypeError(f"tap_weight_fwd: taps and w must both be float32 or bfloat16, got "
                        f"{taps.dtype} and {w.dtype}")
    if taps.requires_grad or w.requires_grad:
        raise RuntimeError("tap_weight_fwd is forward-only: run it under torch.no_grad() "
                           "(the backward is not ported yet)")
    if not (taps.is_contiguous() and w.is_contiguous()):
        raise ValueError("tap_weight_fwd: inputs must be contiguous")
    b, q, t = _check_shapes(taps, w, n_points, n_heads, d)
    out = torch.empty((b, q, n_heads * d), dtype=taps.dtype, device=taps.device)
    err = library().tap_weight_fwd(
        taps.data_ptr(), w.data_ptr(), out.data_ptr(), b, q, n_points, t, n_heads, d,
        DTYPE_CODES[taps.dtype], torch.cuda.current_stream(taps.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tap_weight_fwd: kernel launch failed with cudaError {err}")
    LAUNCHES += 1
    return out


def weight_taps(taps: torch.Tensor, w: torch.Tensor, n_points: int, n_heads: int,
                d: int) -> torch.Tensor:
    """taps (B, P*Q, T*M*D) float32/bfloat16, w (B, P*Q, T*M) -> (B, Q, M*D)
    in taps.dtype, accumulated in float32 by the kernel. CUDA tensors go to
    K2, CPU tensors to the plain version."""
    if taps.is_cuda:
        return tap_weight_fwd(taps, w, n_points, n_heads, d)
    _check_shapes(taps, w, n_points, n_heads, d)
    return weight_taps_plain(taps, w, n_points, n_heads, d)
