"""2-D sine position embedding for unmasked maps (reference
position_encoding.py:12-64, `mp_former_tpu/.../position_encoding.py`).

With no padding mask the cumulative sums reduce to index grids. Returns
(H, W, 2 * num_pos_feats) with the channels ordered (y-features, x-features)
like the reference's cat((pos_y, pos_x)).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 128,
                            device: Optional[torch.device] = None,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalised to (0, 2 pi], temperature 10000: the only settings the
    pixel decoder and the transformer decoder use."""
    eps, scale = 1e-6, 2 * math.pi
    y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x_embed = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y_embed = y_embed / (h + eps) * scale
    x_embed = x_embed / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = 10000 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack((pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()), dim=3).flatten(2)
    pos_y = torch.stack((pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()), dim=3).flatten(2)
    return torch.cat((pos_y, pos_x), dim=2).to(dtype)
