"""Bytes and operations of a call of the port's kernel entries, from the
shapes and types of the call's own tensors alone, so that counting launches
nothing on the card, for the roofline shares (`readers/roofline.py`). A
cost is (bytes, flops, peak): the bytes read each input once and write each
output once; the operations are `flops.py`'s, which count every sampling
point of K1 as the kernel's work (an upper bound: a point off the map costs
the kernel less; at the cells' shapes K1's bound is set by its bytes); `peak`
names the arithmetic in `flops.PEAK_FLOPS`. Float32 K3 runs on the tensor
cores as 3xTF32, three times the operations at the TF32 peak (`chip_smoke.py`'s
bound arithmetic)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flops

Cost = Tuple[int, float, str]


def _bytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _peak(dtype: torch.dtype) -> str:
    return "bfloat16" if dtype in (torch.bfloat16, torch.float16) else "float32"


def k1(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
       attention_weights: torch.Tensor, *rest, **kwargs) -> Tuple[Cost, Optional[Cost]]:
    """`ops/ms_deform_attn.py:ms_deform_attn`: value (B, S, M, D), locations
    (B, Q, M, L, P, 2) in [0, 1], weights (B, Q, M, L, P) -> (B, Q, M * D)."""
    B, Q, M = sampling_locations.shape[:3]
    D = value.shape[-1]
    points = flops.k1_points(sampling_locations)
    out_bytes = B * Q * M * D * value.element_size()
    peak = _peak(value.dtype)
    fwd = (_bytes(value, sampling_locations, attention_weights) + out_bytes,
           flops.k1_flops(points, D), peak)
    # the output gradient, the three inputs, the location and weight gradients,
    # and the value gradient, which the kernel sums in float32
    bwd = (out_bytes + _bytes(value, sampling_locations, attention_weights)
           + _bytes(sampling_locations, attention_weights) + value.numel() * 4,
           flops.k1_backward_flops(points, D), peak)
    return fwd, bwd


def k3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
       *rest, **kwargs) -> Tuple[Cost, Optional[Cost]]:
    """`ops/masked_attention_cuda.py:masked_attention`: q (B, H, Q, D), k and v
    (B, H, S, D), mask (B, Q, S) or (B, H, Q, S) -> (B, H, Q, D)."""
    B, H, Q, D = q.shape
    S = k.shape[2]
    tf32 = q.dtype == torch.float32
    scale, peak = (3, "tf32") if tf32 else (1, _peak(q.dtype))
    fwd = (_bytes(q, k, v, mask) + _bytes(q), scale * flops.k3_flops(B, H, Q, S, D), peak)
    # q, k, v, the float32 output, its gradient, the mask, a float32 row
    # statistic, and the three gradients
    bwd = (_bytes(q, k, v) + q.numel() * 4 + _bytes(q) + _bytes(mask) + B * H * Q * 4
           + _bytes(q, k, v), scale * flops.k3_backward_flops(B, H, Q, S, D), peak)
    return fwd, bwd
