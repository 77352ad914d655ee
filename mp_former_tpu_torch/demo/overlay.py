"""The demos' drawings (`demo/demo.py:18-44` and `predict.py:80-86` of the
JAX package) and how they reach the disk.

The overlays equal the JAX package's bit for bit where cv2 is installed:
its labels are drawn and its file names and writer are used. Where cv2 is
not installed, the blended pixels are the same and the `putText` labels and
contours are left out, which is logged once; images are then written as PNG
through `zlib`. That path is held by
`tests/test_torch_demo.py::test_cli_runs_without_jax_cv2_or_pil`.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_WARNED = set()


def optional_cv2(what: str = "the labels"):
    """cv2 where it is installed; else None, logging once per `what` that
    it needs cv2."""
    try:
        import cv2
    except ImportError:
        if what not in _WARNED:
            _WARNED.add(what)
            logger.warning("cv2 is not installed: %s are not drawn", what)
        return None
    return cv2


def color_palette(n: int, seed: int = 7) -> np.ndarray:
    return np.random.RandomState(seed).randint(64, 255, size=(n, 3), dtype=np.uint8)


def overlay_instances(image_bgr: np.ndarray, scores, classes, masks,
                      class_names: Optional[Sequence[str]] = None,
                      threshold: float = 0.5) -> np.ndarray:
    """Each instance at or above `threshold`, lowest score first, blended
    half and half with its palette colour, with its "name score" label."""
    cv2 = optional_cv2()
    out = image_bgr.copy()
    colors = color_palette(len(scores))
    for i in np.argsort(scores):
        if scores[i] < threshold:
            continue
        m = masks[i].astype(bool)
        out[m] = (0.5 * out[m] + 0.5 * colors[i]).astype(np.uint8)
        ys, xs = np.nonzero(m)
        if len(ys) and cv2 is not None:
            name = class_names[classes[i]] if class_names else str(classes[i])
            cv2.putText(out, f"{name} {scores[i]:.2f}",
                        (int(xs.min()), max(int(ys.min()) - 3, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, colors[i].tolist(), 1)
    return out


def overlay_semantic(image_bgr: np.ndarray, sem_probs: np.ndarray) -> np.ndarray:
    """(K, H, W) class probabilities: the argmax's palette colour blended
    half and half."""
    seg = sem_probs.argmax(0)
    colors = color_palette(int(seg.max()) + 1)
    return (0.5 * image_bgr + 0.5 * colors[seg][:, :, ::-1]).astype(np.uint8)


def overlay_panoptic(image_bgr: np.ndarray, pan_map: np.ndarray) -> np.ndarray:
    """The panoptic id map in `RandomState(11)` colours, id 0 black, blended
    half and half (`predict.py:80-86`)."""
    colors = np.random.RandomState(11).randint(0, 255, (int(pan_map.max()) + 1, 3), np.uint8)
    colors[0] = 0
    return (0.5 * image_bgr + 0.5 * colors[pan_map][:, :, ::-1]).astype(np.uint8)


def png_bytes(image_bgr: np.ndarray) -> bytes:
    """(H, W, 3) uint8 BGR -> an 8-bit RGB PNG file's bytes (filter 0 on
    every row, zlib level 6)."""
    h, w = image_bgr.shape[:2]
    rgb = np.ascontiguousarray(image_bgr[..., ::-1], np.uint8).reshape(h, w * 3)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_image(path: str, image_bgr: np.ndarray) -> str:
    """Write `image_bgr` at `path` with cv2 where it is installed (the JAX
    demos' own writer); else as PNG through zlib, at `path` with a `.png`
    extension. Returns the path written."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        if not cv2.imwrite(path, image_bgr):
            raise OSError(f"cv2 could not write {path}")
        return path
    path = os.path.splitext(path)[0] + ".png"
    with open(path, "wb") as f:
        f.write(png_bytes(image_bgr))
    return path
