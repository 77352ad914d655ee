#!/usr/bin/env python3
"""What bounds masked cross-attention (K3) on one CUDA card.

    python3 tools/probe_torch_masked_attn_bound.py [--seed 0] [--queries 100]

At the decoder's shape (B1 H8 Q100 D32, float32) and its three key lengths at
an 800x1088 canvas (S = 850, 3400, 13600), by device time (CUDA graph replay):

  port        the port's K3 (`csrc/masked_attn_fwd.cu`) with the split over the
              keys that its wrapper chooses, and with the number of key chunks
              swept;
  first       the first design of K3, kept in
              `tools/probe_torch_masked_attn_bound.cu` (one thread a query row,
              scalar fp32 FMAs, plain loads between two barriers, a serial
              merge kernel): as it was; its partial kernel alone and its merge
              kernel alone; with the number of key chunks swept (1 to 33);
              with the mask reads removed; with the products removed (loads,
              softmax and exponentials stay).

  variants    with `--variants`: the port's kernel rebuilt with one thing
              changed each time, by a textual substitution in its source (the
              tool raises if the source has moved on and a substitution no
              longer applies): one TF32 product instead of three, the operand
              split made free, the mask reads removed, the exponential made
              free, a ring of 3 stages. They are timed, not checked: most
              compute something else.

The differences say how much of each key length is arithmetic issue, load
latency, the split over the keys and the second launch. Every kernel that
computes the whole function is first held against the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PROBE_SOURCE = Path(__file__).with_suffix(".cu")
TOL = 1e-4  # float32: other summation order, a few ulp of outputs of magnitude ~1
KEYS = (850, 3400, 13600)
CHUNK_COUNTS = (1, 2, 4, 8, 16, 33)


def probe_library():
    """Build `tools/probe_torch_masked_attn_bound.cu` beside the port's kernels."""
    from mp_former_tpu_torch.ops import cuda_build

    digest = hashlib.sha256(PROBE_SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = cuda_build.BUILD_ROOT / f"probe_masked_attn_{digest}"
    path = out_dir / "libmasked_attn_probe.so"
    if not path.is_file():
        cuda_build.compile_library([PROBE_SOURCE], out_dir, path.name)
    for line in (out_dir / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.masked_attn_probe.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, i, i, i, p]
    lib.masked_attn_probe.restype = i
    return lib


# name -> [(text in csrc/masked_attn_fwd.cu, its replacement)]; a text ending
# in "..." stands for every line that starts with it (after indentation)
VARIANTS = {
    "one_tf32_product": [("mma_tf32(c0, a_small, ...", ""), ("mma_tf32(c1, a_small, ...", ""),
                         ("mma_tf32(c2, a_small, ...", ""), ("mma_tf32(c3, a_small, ...", ""),
                         ("mma_tf32(c0, a_big, b[0][0].y, ...", ""),
                         ("mma_tf32(c1, a_big, b[1][0].y, ...", ""),
                         ("mma_tf32(c2, a_big, b[2][0].y, ...", ""),
                         ("mma_tf32(c3, a_big, b[3][0].y, ...", "")],
    "free_split": [('  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));\n'
                    '  const float rest = x - __uint_as_float(big);\n'
                    '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));',
                    '  big = __float_as_uint(x);\n  small = 0x3a000000u;')],
    "no_mask_reads": [("if (mrow_lo[j * 8]) ...", ""), ("if (mrow_lo[j * 8 + 1]) ...", ""),
                      ("if (mrow_hi[j * 8]) ...", ""), ("if (mrow_hi[j * 8 + 1]) ...", "")],
    "free_exponential": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                          "y = x * 0.001f;")],
    "three_stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
}


def variant_library(name: str):
    """The port's K3 rebuilt with the substitutions of VARIANTS[name]."""
    from mp_former_tpu_torch.ops import cuda_build

    source = (cuda_build.CSRC / "masked_attn_fwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if old.endswith("..."):
            lines = source.splitlines(True)
            kept = [ln for ln in lines if not ln.lstrip().startswith(old[:-3])]
            if len(kept) != len(lines) - 1:
                raise RuntimeError(f"variant {name}: {old!r} matches {len(lines) - len(kept)} "
                                   "lines of the kernel's source, not 1")
            source = "".join(kept)
        else:
            if source.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} no longer stands once in the "
                                   "kernel's source")
            source = source.replace(old, new)
    digest = hashlib.sha256(source.encode()).hexdigest()[:16]
    out_dir = cuda_build.BUILD_ROOT / f"probe_masked_attn_{name}_{digest}"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "libmasked_attn_variant.so"
    if not path.is_file():
        (out_dir / "masked_attn_fwd.cu").write_text(source)
        cuda_build.compile_library([out_dir / "masked_attn_fwd.cu"], out_dir, path.name)
    lib = ctypes.CDLL(str(path))
    lib.masked_attn_fwd.argtypes = cuda_build.library().masked_attn_fwd.argtypes
    lib.masked_attn_fwd.restype = ctypes.c_int
    return lib


def time_variants(inputs, device_ms) -> dict:
    """{variant: {S: device ms}} through the port's own wrapper, with the
    library it launches swapped for the variant's."""
    from mp_former_tpu_torch.ops import cuda_build
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac

    times = {}
    real = cuda_build.library
    try:
        for name in VARIANTS:
            lib = variant_library(name)
            cuda_build.library = lambda lib=lib: lib
            times[name] = {str(S): device_ms(lambda: mac.masked_attn_fwd(q, k, v, mask))
                           for S, (q, k, v, mask) in inputs.items()}
    finally:
        cuda_build.library = real
    return times


def chunk_for(S: int, chunks: int) -> int:
    """Keys per chunk, whole 32-key tiles, for about `chunks` chunks of S keys."""
    return -(-(-(-S // chunks)) // 32) * 32


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--variants", action="store_true",
                    help="also time one-change variants of the port's kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_masked_attn_bound: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.utils.cuda_timing import card_string, device_ms

    card = card_string()
    lib = probe_library()
    B, H, Q, D = 1, 8, args.queries, 32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": card, "shape": f"B{B}xH{H}xQ{Q}xD{D}", "dtype": "float32",
              "clock": "device time by CUDA graph replay", "ms": {}}
    inputs = {}
    for S in KEYS:
        q, k, v = (torch.randn((B, H, n, D), generator=g, device="cuda") for n in (Q, S, S))
        mask = torch.rand((B, Q, S), generator=g, device="cuda") < 0.7
        mask[:, :5] = True
        inputs[S] = (q, k, v, mask)
        want = mac.masked_attention_plain(q, k, v, mask)
        max_chunks = -(-S // 32)
        scratch = torch.empty((B * H * max_chunks * Q * (D + 2),), device="cuda")

        def first(chunks: int, variant: int = 0, which: int = 0):
            chunk = chunk_for(S, chunks)
            n = -(-S // chunk)
            rows = B * H * n * Q
            out = torch.empty_like(q)
            err = lib.masked_attn_probe(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), scratch.data_ptr(),
                scratch.data_ptr() + 4 * rows * D, scratch.data_ptr() + 4 * rows * (D + 1),
                out.data_ptr(), B, H, Q, S, Q * S, 0, chunk, variant, which,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"masked_attn_probe: cudaError {err}")
            return out

        def check(name, out):
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if not err <= TOL:
                raise AssertionError(f"{name} S={S}: max abs error {err} above {TOL}")
            return err

        default = max(1, -(-2 * sms // (B * H)))  # the first design's rule: 33 chunks
        times = {}
        port_err = check("port", mac.masked_attn_fwd(q, k, v, mask))
        times["port"] = device_ms(lambda: mac.masked_attn_fwd(q, k, v, mask))
        for tiles in (1, 2, 4, 8, 16, 32):
            check(f"port chunk {64 * tiles}", mac.masked_attn_fwd(q, k, v, mask, chunk=64 * tiles))
            times[f"port_chunk_{64 * tiles}"] = device_ms(
                lambda: mac.masked_attn_fwd(q, k, v, mask, chunk=64 * tiles))
        first_err = check("first", first(default))
        times["first"] = device_ms(lambda: first(default))
        times["first_partial_alone"] = device_ms(lambda: first(default, which=1))
        times["first_merge_alone"] = device_ms(lambda: first(default, which=2))
        for chunks in CHUNK_COUNTS:
            check(f"first, {chunks} chunks", first(chunks))
            times[f"first_chunks_{chunks}"] = device_ms(lambda: first(chunks))
        times["first_no_mask_reads"] = device_ms(lambda: first(default, variant=1))
        times["first_no_products"] = device_ms(lambda: first(default, variant=2))
        result["ms"][str(S)] = times
        print(f"[masked_attn_bound] S={S} port_max_abs_err={port_err:.3e} "
              f"first_max_abs_err={first_err:.3e} tol={TOL} "
              + " ".join(f"{name}_ms={t:.5f}" for name, t in times.items())
              + f" card={card!r}", flush=True)
    if args.variants:
        result["variants_ms"] = time_variants(inputs, device_ms)
        for name, by_key in result["variants_ms"].items():
            print(f"[masked_attn_bound] variant={name} "
                  + " ".join(f"S{S}_ms={t:.5f}" for S, t in by_key.items())
                  + f" card={card!r}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
