"""Box utilities on tensors (reference util/box_ops.py, the subset the JAX
package keeps in `mp_former_tpu/utils/boxes.py`)."""

import torch


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> cxcywh (reference util/box_ops.py, used at
    maskformer_model.py:295)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool or float masks (a float counts above 0.5) -> (N, 4)
    float32 tight xyxy boxes, as torchvision's masks_to_boxes; an empty mask
    gives a zero box."""
    n, h, w = masks.shape
    m = masks > 0.5 if masks.is_floating_point() else masks.bool()
    ys = torch.arange(h, device=masks.device)
    xs = torch.arange(w, device=masks.device)
    any_row = m.any(dim=2)  # (N, H)
    any_col = m.any(dim=1)  # (N, W)
    big = torch.iinfo(torch.int64).max
    y0 = torch.where(any_row, ys, big).amin(dim=1)
    y1 = torch.where(any_row, ys, -1).amax(dim=1)
    x0 = torch.where(any_col, xs, big).amin(dim=1)
    x1 = torch.where(any_col, xs, -1).amax(dim=1)
    boxes = torch.stack([x0, y0, x1, y1], dim=-1).float()
    empty = ~any_row.any(dim=1)
    return torch.where(empty[:, None], torch.zeros_like(boxes), boxes)
