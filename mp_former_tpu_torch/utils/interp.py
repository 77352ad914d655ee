"""Resizing on the trailing (H, W) axes (`mp_former_tpu/utils/interp.py`).

The JAX package builds interpolation matrices that equal torch's own
`F.interpolate` (bilinear with align_corners=False, legacy nearest, and area,
`interp.py:31-71`), so here the port calls `F.interpolate` directly, and
`F.grid_sample` for `grid_sample` / `point_sample` (`interp.py:116,169`), in
the JAX package's channels-last layout.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize the last two axes of ``x`` to ``size`` (any leading dims).

    method: 'bilinear' (align_corners=False), 'nearest', or 'area'.
    """
    h, w = x.shape[-2:]
    oh, ow = int(size[0]), int(size[1])
    if (h, w) == (oh, ow):
        return x
    if method not in ("bilinear", "nearest", "area"):
        raise ValueError(f"Unknown resize method: {method}")
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1, h, w))
    kwargs = {"align_corners": False} if method == "bilinear" else {}
    y = F.interpolate(x4, size=(oh, ow), mode=method, **kwargs)
    return y.reshape(lead + (oh, ow))


def grid_sample(x: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """Bilinear sampling with zero padding. x (B, H, W, C), grid (B, P, 2) in
    [-1, 1] as (x, y) -> (B, P, C)."""
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners)  # (B, C, 1, P)
    return out[:, :, 0].transpose(1, 2)


def point_sample(x: torch.Tensor, point_coords: torch.Tensor,
                 align_corners: bool = False) -> torch.Tensor:
    """point_rend's point_sample: x (B, H, W, C), point_coords (B, P, 2) in
    [0, 1] as (x, y) -> (B, P, C)."""
    return grid_sample(x, 2.0 * point_coords - 1.0, align_corners=align_corners)
