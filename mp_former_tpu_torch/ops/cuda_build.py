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
    """Of the flags, the sources and the headers beside them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def compile_library(sources, out_dir: Path, lib_name: str = LIB_NAME) -> Path:
    """Compile `sources` with nvcc (one process per source, side by side; the
    port's headers under `csrc/` on the include path) and link them into
    `out_dir/lib_name`; the log (ptxas register and shared memory use) is kept
    beside it as `build.log`. Raises if nvcc is missing or fails."""
    lib = out_dir / lib_name
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as obj_dir:
        objects = [os.path.join(obj_dir, src.stem + ".o") for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)]
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


def build() -> Path:
    """Compile the port's kernels if no library for the current sources
    exists; return the library's path."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    return compile_library(sources, out_dir)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.msda_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.msda_fwd.restype = i
    lib.msda_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.msda_bwd.restype = i
    lib.masked_attn_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, *[ll] * 14, i, i, p]
    lib.masked_attn_fwd.restype = i
    lib.masked_attn_bwd.argtypes = [*[p] * 11, i, i, i, i, i, *[ll] * 17, i, i, p]
    lib.masked_attn_bwd.restype = i
    lib.tap_weight_fwd.argtypes = [p, p, p, ll, ll, i, i, i, i, i, p]
    lib.tap_weight_fwd.restype = i
    lib.row_gather.argtypes = [p, p, p, ll, ll, i, p]
    lib.row_gather.restype = i
    lib.row_gather_sum.argtypes = [p, p, p, ll, i, i, i, i, p]
    lib.row_gather_sum.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of device `index` (asked once per device)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_inputs(name: str, typed, dtypes, others=(), align: int = 1,
                 strided: int = 0) -> torch.device:
    """The checks that guard every kernel, in one pass: `typed` and `others`
    are CUDA tensors on one device, contiguous and detached from autograd (the
    kernels with a backward are joined to it by their `torch.autograd.Function`,
    which calls the raw wrappers on detached tensors); the `typed`
    ones all have one type out of `dtypes` and start on a multiple of `align`
    bytes (for a kernel that reads 16 bytes a thread whatever it is given: a
    contiguous view with a storage offset can start elsewhere). The first
    `strided` of `typed` go to a kernel that takes their strides: only their
    last dimension must be contiguous, and every other stride a multiple of
    `align` bytes. Returns the device."""
    first = typed[0]
    device = first.device
    for n, t in enumerate((*typed, *others)):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: all inputs must be CUDA tensors on one device")
        if n < len(typed) and (t.dtype != first.dtype or t.dtype not in dtypes):
            raise TypeError(f"{name}: inputs must all be "
                            f"{' or '.join(str(d).split('.')[1] for d in dtypes)}, got "
                            f"{[str(u.dtype) for u in typed]}")
        if t.requires_grad:
            raise RuntimeError(
                f"{name} is forward-only and takes no tensor that requires a gradient: run it "
                "under torch.no_grad(). Gradients of K1 and K3 go through ops.ms_deform_attn."
                "ms_deform_attn and ops.masked_attention_cuda.masked_attention; the backward of "
                "K2 (tap weighting) is not ported yet, it belongs to the slice that trains the "
                "TPU recipe, and the row gathers have none")
        if n < strided:
            strides, size, bad = t.stride(), t.element_size(), False
            for st, extent in zip(strides[:-1], t.shape):  # a stride of an extent of 1 is never used
                bad |= extent > 1 and st * size % align != 0
            if bad or (strides[-1] != 1 and t.shape[-1] > 1):
                raise ValueError(f"{name}: the last dimension must be contiguous and every "
                                 f"other stride a multiple of {align} bytes, got strides "
                                 f"{strides}")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if n < len(typed) and t.data_ptr() % align:
            raise ValueError(f"{name}: inputs must start on a {align}-byte boundary (a view with "
                             "a storage offset may not: pass a copy)")
    return device


def launch(name: str, device: torch.device, *args) -> None:
    """Call the entry point `name` with `args` and, as its last argument, the
    raw handle of PyTorch's current stream on `device` (inside
    `torch.cuda.graph` that is the capturing stream), with `device` current.
    The launch is asynchronous. Raises if it was refused."""
    fn = getattr(library(), name)
    index = device.index
    # the handle straight from the C++ side, as an int: `torch.cuda.current_stream`
    # builds a Stream object on every call to reach the same integer
    raw_stream = torch._C._cuda_getCurrentRawStream
    if index == torch.cuda.current_device():
        err = fn(*args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
