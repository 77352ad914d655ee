"""Build and load the port's CUDA kernels (`mp_former_tpu_torch/csrc/*.cu`).

The kernels have a plain C interface and are compiled by `nvcc` (one process
per source, all started together) and linked into one shared library, loaded
with `ctypes`; no PyTorch header is included, so a build takes seconds. The
library is built at first use into
`build/torch_kernels/<hash>/` of the checkout, where the hash covers the
sources and the flags, so an edited kernel is rebuilt and an unchanged one
is reused. Without `nvcc` the build raises: there is no other way to a
kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libmpf_kernels.so"
# the `dtype` argument of every entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels cannot be built")
    return found


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if no library for the current sources exists;
    return the library's path. The build log (ptxas register and shared
    memory use) is kept beside it as `build.log`."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as obj_dir:
        # one nvcc per source, side by side; then one link
        objects = [os.path.join(obj_dir, src.stem + ".o") for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        outputs = [proc.communicate()[0] for proc in procs]
        log = "".join(f"$ {' '.join(cmd)}\n{out}[exit {proc.returncode}]\n"
                      for cmd, out, proc in zip(cmds, outputs, procs))
        ok = all(proc.returncode == 0 for proc in procs)
        if ok:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc, "-shared", "-o", tmp, *objects]
            link = subprocess.run(cmd, capture_output=True, text=True)
            log += f"$ {' '.join(cmd)}\n{link.stdout}{link.stderr}[exit {link.returncode}]\n"
            ok = link.returncode == 0
            if not ok:
                os.unlink(tmp)
    log += f"[{time.perf_counter() - t0:.2f} s]\n"
    (out_dir / "build.log").write_text(log)
    if not ok:
        raise RuntimeError(f"nvcc failed building the CUDA kernels:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.msda_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.msda_fwd.restype = i
    lib.masked_attn_fwd.argtypes = [p, p, p, p, p, p, p, p,
                                    i, i, i, i, i, ll, ll, i, i, p]
    lib.masked_attn_fwd.restype = i
    lib.tap_weight_fwd.argtypes = [p, p, p, ll, ll, i, i, i, i, i, p]
    lib.tap_weight_fwd.restype = i
    lib.row_gather.argtypes = [p, p, p, ll, ll, i, p]
    lib.row_gather.restype = i
    lib.row_gather_sum.argtypes = [p, p, p, ll, i, i, i, p]
    lib.row_gather_sum.restype = i
    return lib
