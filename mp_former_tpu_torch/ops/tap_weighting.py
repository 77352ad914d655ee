"""Tap weighting: the CUDA kernel K2 and its plain version.

The head-shared sampling engine gathers rows that carry the 2x2 bilinear
taps of all M heads for one (query, point), and the per-head 2x2-patch engine
gathers rows with the taps of one head; both then reduce them with
per-(point, tap, head) weights:

    out[b, q, (m d)] = sum over p, t of taps[b, (p q), (t m d)] * w[b, (p q), (t m)]

`weight_taps` is the counterpart of `mp_former_tpu/ops/tap_weighting.py:
weight_taps`: CUDA tensors launch `csrc/tap_weight_fwd.cu` (the port of the
TPU kernels `_call_one` / `_call_batched`), and where a gradient is asked for
they go through `TapWeightingFunction`, whose backward launches
`csrc/tap_weight_bwd.cu` (the port of the custom_vjp's `_bwd`, plain XLA in
the JAX package); CPU tensors take `weight_taps_plain` (the JAX package's
`weight_taps_reference`) and autograd's backward of it, which
`weight_taps_backward_plain` writes out.

Rows are point-major ((p, q) order), lanes (t, m, d) major to minor.
"""

from __future__ import annotations

import torch

from ..utils import flops
from .cuda_build import DTYPE_CODES, check_inputs, launch

# launches of the forward and the backward kernel since the last reset
LAUNCHES = 0
BWD_LAUNCHES = 0


def weight_taps_plain(taps: torch.Tensor, w: torch.Tensor, n_points: int, n_heads: int,
                      d: int) -> torch.Tensor:
    """taps (B, P*Q, T*M*D), w (B, P*Q, T*M) -> (B, Q, M*D) in taps.dtype."""
    b, pq, tmd = taps.shape
    q = pq // n_points
    t = tmd // (n_heads * d)
    wt = (taps.reshape(b, n_points, q, t, n_heads, d)
          * w.reshape(b, n_points, q, t, n_heads, 1).to(taps.dtype))
    return wt.sum(dim=(1, 3)).reshape(b, q, n_heads * d)


def weight_taps_backward_plain(taps: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                               n_points: int, n_heads: int, d: int):
    """The gradients of `weight_taps_plain` for the gradient g (B, Q, M*D) of
    its output (the JAX package's `_bwd`): grad_taps[b, (p q), (t m d)] =
    g[b, q, (m d)] * w[b, (p q), (t m)] in float32, returned in taps.dtype;
    grad_w[b, (p q), (t m)] = the sum over d of taps * g, accumulated in
    float32 and returned in w.dtype."""
    b, pq, tmd = taps.shape
    q = pq // n_points
    t = tmd // (n_heads * d)
    g5 = g.float().reshape(b, 1, q, 1, n_heads, d)
    grad_taps = g5 * w.float().reshape(b, n_points, q, t, n_heads, 1)
    grad_w = (taps.float().reshape(b, n_points, q, t, n_heads, d) * g5).sum(-1)
    return grad_taps.reshape(taps.shape).to(taps.dtype), grad_w.reshape(w.shape).to(w.dtype)


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
    """Launch K2 on CUDA tensors that require no gradient (`weight_taps`
    joins it to autograd); raises on anything it does not take, and if the
    launch fails."""
    global LAUNCHES
    device = check_inputs("tap_weight_fwd", (taps, w), tuple(DTYPE_CODES))
    b, q, t = _check_shapes(taps, w, n_points, n_heads, d)
    out = torch.empty((b, q, n_heads * d), dtype=taps.dtype, device=taps.device)
    launch("tap_weight_fwd", device, taps.data_ptr(), w.data_ptr(), out.data_ptr(),
           b, q, n_points, t, n_heads, d, DTYPE_CODES[taps.dtype])
    LAUNCHES += 1
    if flops.counting():
        flops.add("K2", flops.k2_flops(taps.numel()))
    return out


def tap_weight_bwd(taps: torch.Tensor, w: torch.Tensor, g: torch.Tensor, n_points: int,
                   n_heads: int, d: int):
    """Launch K2's backward on CUDA tensors: (grad_taps, grad_w) in the shapes
    and type of taps and w, for the gradient g (B, Q, M*D) of K2's output, of
    the same type. Raises on anything it does not take, and if the launch
    fails."""
    global BWD_LAUNCHES
    device = check_inputs("tap_weight_bwd", (taps, w, g), tuple(DTYPE_CODES))
    b, q, t = _check_shapes(taps, w, n_points, n_heads, d)
    if g.shape != (b, q, n_heads * d):
        raise ValueError(f"tap_weight_bwd: g {tuple(g.shape)} is not {(b, q, n_heads * d)}")
    grad_taps = torch.empty_like(taps)
    grad_w = torch.empty_like(w)
    launch("tap_weight_bwd", device, taps.data_ptr(), w.data_ptr(), g.data_ptr(),
           grad_taps.data_ptr(), grad_w.data_ptr(), b, q, n_points, t, n_heads, d,
           DTYPE_CODES[taps.dtype])
    BWD_LAUNCHES += 1
    if flops.counting():
        flops.add("K2 backward", flops.k2_backward_flops(taps.numel()))
    return grad_taps, grad_w


class TapWeightingFunction(torch.autograd.Function):
    """K2 with its gradient on CUDA tensors: `tap_weight_fwd` forward,
    `tap_weight_bwd` backward; taps and w are saved, as the JAX `_fwd` saves
    them. apply(taps, w, n_points, n_heads, d)."""

    @staticmethod
    def forward(ctx, taps, w, n_points, n_heads, d):
        taps, w = taps.detach(), w.detach()
        ctx.save_for_backward(taps, w)
        ctx.dims = (n_points, n_heads, d)
        return tap_weight_fwd(taps, w, n_points, n_heads, d)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        taps, w = ctx.saved_tensors
        grad_taps, grad_w = tap_weight_bwd(taps, w, grad_out.contiguous(), *ctx.dims)
        return grad_taps, grad_w, None, None, None


def weight_taps(taps: torch.Tensor, w: torch.Tensor, n_points: int, n_heads: int,
                d: int) -> torch.Tensor:
    """taps (B, P*Q, T*M*D) float32/bfloat16, w (B, P*Q, T*M) -> (B, Q, M*D)
    in taps.dtype, accumulated in float32 by the kernel. CUDA tensors go to
    K2 (through `TapWeightingFunction` where autograd records and an input
    requires a gradient), CPU tensors to the plain version."""
    if taps.is_cuda:
        if torch.is_grad_enabled() and (taps.requires_grad or w.requires_grad):
            return TapWeightingFunction.apply(taps, w, n_points, n_heads, d)
        # autograd records nothing here
        return tap_weight_fwd(taps.detach(), w.detach(), n_points, n_heads, d)
    _check_shapes(taps, w, n_points, n_heads, d)
    if flops.counting():
        return flops.plain_counted(lambda *tw: weight_taps_plain(*tw, n_points, n_heads, d), "K2",
                                   flops.k2_flops(taps.numel()),
                                   flops.k2_backward_flops(taps.numel()), taps, w)
    return weight_taps_plain(taps, w, n_points, n_heads, d)
