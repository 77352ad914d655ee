"""The COCO polygon rasteriser (`maskapi.cc`, the port's copy of
`mp_former_tpu/native/maskapi.cc`: pycocotools' subpixel scheme, a 5x
upsampled boundary and a parity fill per column), loaded with `ctypes`.

The library is built with g++ at first use, never on import, into
`build/torch_native/<hash>/` of the checkout, where the hash covers the
source and the flags. Where g++ is missing or the build fails, the call
raises with the compiler's output: there is no other rasteriser, so ground
truth is never drawn by a different rule than the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

import numpy as np

SOURCE = Path(__file__).resolve().parent / "maskapi.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIB_NAME = "libmaskapi.so"


def build() -> Path:
    """Compile `maskapi.cc` if no library for the current source exists;
    return the library's path. Raises if g++ is missing or fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the polygon rasteriser "
                           f"{SOURCE} cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed building the polygon rasteriser:\n$ {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}[exit {res.returncode}]")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.polys_to_mask.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.polys_to_mask.restype = None
    return lib


def polygons_to_mask(polygons: List[np.ndarray], h: int, w: int) -> np.ndarray:
    """COCO polygons (flat x, y lists; fewer than 3 vertices are skipped) ->
    (h, w) bool, the parts of one object merged."""
    flat = [np.asarray(p, np.float64).reshape(-1) for p in polygons if len(p) >= 6]
    if not flat:
        return np.zeros((h, w), bool)
    xy = np.ascontiguousarray(np.concatenate(flat))
    sizes = np.asarray([len(f) // 2 for f in flat], np.int32)
    out = np.zeros((w, h), np.uint8)  # column-major: w columns of h
    library().polys_to_mask(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(sizes), h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.T.astype(bool)
