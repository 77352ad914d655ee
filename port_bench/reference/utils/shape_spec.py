"""ShapeSpec — lightweight feature-shape metadata (d2 equivalent)."""

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ShapeSpec:
    channels: Optional[int] = None
    height: Optional[int] = None
    width: Optional[int] = None
    stride: Optional[int] = None
