"""TrackVisualizer: video instance tracks drawn with one colour a track for
the whole clip (reference demo_video/visualizer.py:13; the port's twin of the
JAX package's `demo_video/visualizer.py`). Masks are blended; contours and
"[id] class score" labels are drawn through cv2 where it is installed, and
left out (logged once) where it is not.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..demo.overlay import optional_cv2

# a distinct base palette (RGB); tracks cycle through it with a deterministic
# jitter a cycle, so that ids beyond the palette stay distinguishable
_BASE_PALETTE = np.array([
    (220, 20, 60), (0, 130, 200), (60, 180, 75), (255, 225, 25),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
    (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
    (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
], np.float64)


def track_color(track_id: int) -> np.ndarray:
    """The RGB colour of a track id (the same in every frame)."""
    base = _BASE_PALETTE[track_id % len(_BASE_PALETTE)]
    rng = np.random.RandomState(track_id)
    jitter = (rng.rand(3) - 0.5) * 60.0 * (track_id // len(_BASE_PALETTE))
    return np.clip(base + jitter, 0, 255)


ALPHA = 0.5  # the masks' blend


class TrackVisualizer:
    def __init__(self, thing_classes: Optional[Sequence[str]] = None):
        self.thing_classes = thing_classes

    def _label(self, track_id: int, cls: int, score: float) -> str:
        name = (self.thing_classes[cls]
                if self.thing_classes and 0 <= cls < len(self.thing_classes) else str(cls))
        return f"[{track_id}] {name} {score:.0%}"

    def draw_frame(self, frame_bgr: np.ndarray, masks: List[np.ndarray],
                   track_ids: Sequence[int], classes: Sequence[int],
                   scores: Sequence[float]) -> np.ndarray:
        """frame_bgr (H, W, 3) uint8; `masks` each track's (H, W) bool mask in
        this frame. Returns the drawn copy."""
        vis = frame_bgr.astype(np.float64).copy()
        for m, tid in zip(masks, track_ids):
            m = m.astype(bool)
            if m.any():
                vis[m] = (1 - ALPHA) * vis[m] + ALPHA * track_color(int(tid))[::-1]
        vis = vis.astype(np.uint8)
        cv2 = optional_cv2("the track contours and labels")
        if cv2 is None:
            return vis
        for m, tid, cls, sc in zip(masks, track_ids, classes, scores):
            m = m.astype(np.uint8)
            if not m.any():
                continue
            color = tuple(int(c) for c in track_color(int(tid))[::-1])
            contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
            cv2.drawContours(vis, contours, -1, color, 2)
            ys, xs = np.nonzero(m)
            org = (int(xs.min()), max(int(ys.min()) - 4, 12))
            txt = self._label(int(tid), int(cls), float(sc))
            cv2.putText(vis, txt, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 3, cv2.LINE_AA)
            cv2.putText(vis, txt, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1,
                        cv2.LINE_AA)
        return vis

    def draw_clip(self, frames_bgr: List[np.ndarray], tubes: np.ndarray,
                  classes: Sequence[int], scores: Sequence[float],
                  score_threshold: float = 0.5) -> List[np.ndarray]:
        """tubes (N, T, H, W) bool, each track's masks over the clip; track i
        keeps colour i in every frame."""
        keep = [i for i, s in enumerate(scores) if s >= score_threshold]
        return [self.draw_frame(frame, [tubes[i, t] for i in keep], keep,
                                [classes[i] for i in keep], [scores[i] for i in keep])
                for t, frame in enumerate(frames_bgr)]
