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

    python3 tools/probe_torch_masked_attn_bound.py --backward

times K3's backward instead, at the training shapes (B8 H8 Q120, S = 256,
1024, 4096) and at B1 H8 Q100 S13600, float32 and bfloat16, strided head
views and per-head masks with a DN block and a row blocked everywhere, as
`chip_smoke.py` phase K3_bwd has them:

  first       the first design, kept in `tools/probe_torch_masked_attn_bwd_first.cu`
              (a thread a key, float32 FMAs, dQ by float32 atomics, a delta
              pre-kernel), with its wrapper's zeroing and casts;
  port        the port's kernel (`csrc/masked_attn_bwd.cu`) through its
              wrapper: dQ through a per-chunk scratch and a merge kernel;
  chunk_N     the port with N keys a block (the wrapper's default marked);
  sdpa        the backward of `F.scaled_dot_product_attention` with an additive
              -1e9 mask (forward and backward less the forward).

Each kernel is first held against the plain backward (float32 1e-4, bfloat16
1e-2 relative to each gradient's largest entry); the port is also run twice
and its two results compared bit for bit. With `--variants` the backward
kernel is also rebuilt with one thing changed each time (BWD_VARIANTS: dQ
added by 16-byte float32 atomics into one zeroed chunk of the scratch, which
the merge kernel then scales and casts; 3 or 4 blocks an SM by launch bounds,
8 warps and 128 keys a block, no dQ product, one TF32 product instead of
three, a free exponential, no mask reads) and timed through the port's
wrapper; the atomics variant computes the same function and is checked as the
kernels are, the others are not.
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
FIRST_BWD_SOURCE = Path(__file__).with_name("probe_torch_masked_attn_bwd_first.cu")
TOL = 1e-4  # float32: other summation order, a few ulp of outputs of magnitude ~1
KEYS = (850, 3400, 13600)
CHUNK_COUNTS = (1, 2, 4, 8, 16, 33)


def probe_library():
    """Build `tools/probe_torch_masked_attn_bound.cu` and the first backward
    (`tools/probe_torch_masked_attn_bwd_first.cu`) beside the port's kernels."""
    from mp_former_tpu_torch.ops import cuda_build

    sources = [PROBE_SOURCE, FIRST_BWD_SOURCE]
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in sources)).hexdigest()[:16]
    out_dir = cuda_build.BUILD_ROOT / f"probe_masked_attn_{digest}"
    path = out_dir / "libmasked_attn_probe.so"
    if not path.is_file():
        cuda_build.compile_library(sources, out_dir, path.name)
    for line in (out_dir / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.masked_attn_probe.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, i, i, i, p]
    lib.masked_attn_probe.restype = i
    lib.masked_attn_bwd_first.argtypes = [*[p] * 11, i, i, i, i, i, *[ll] * 17, i, p]
    lib.masked_attn_bwd_first.restype = i
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


# the same for the backward (`--backward --variants`), in csrc/masked_attn_bwd.cu
# with the shared building blocks inlined
BWD_VARIANTS = {
    "dq_by_atomics": [
        ("float* dst = p.part + (((long long)c * gridDim.y + bh) * p.Q + q) * kD + u * 4;\n"
         "      *reinterpret_cast<float4*>(dst) = a;",
         "float* dst = p.part + ((long long)bh * p.Q + q) * kD + u * 4;\n"
         "      atomicAdd(reinterpret_cast<float4*>(dst), a);"),
        ("  masked_attn_bwd_keys<T><<<grid, kThreads, smem, stream>>>(p);",
         "  if (p.chunks > 1) cudaMemsetAsync(p.part, 0, (size_t)BH * p.Q * kD * 4, stream);\n"
         "  masked_attn_bwd_keys<T><<<grid, kThreads, smem, stream>>>(p);"),
        ("for (int c = 0; c < p.chunks; ++c) {", "for (int c = 0; c < 1; ++c) {")],
    "three_blocks_per_sm": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
    "four_blocks_per_sm": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 4)")],
    "eight_warps": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                    ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
    "no_dq_product": [("tile_dq(acc, ds_tile, reinterpret_cast<const uint2*>(k_tile), m_tile, "
                       "n_first, g, t);", "{}"),
                      ("tile_dq(acc, ds_tile, k_tile, m_tile, n_first, g, t);", "{}")],
    "one_tf32_product": VARIANTS["one_tf32_product"] + [
        ("    #pragma unroll\n    for (int n = 0; n < kNT; ++n) mma_tf32(acc[n], small, "
         "b[n][0].x, b[n][1].x);\n", ""),
        ("    #pragma unroll\n    for (int n = 0; n < kNT; ++n) mma_tf32(acc[n], big, "
         "b[n][0].y, b[n][1].y);\n", "")],
    "free_exponential": VARIANTS["free_exponential"],
    "no_mask_reads": [("const bool blocked = mrow[8 * half] != 0;", "const bool blocked = false;")],
}
BWD_CHECKED_VARIANTS = ("dq_by_atomics",)  # the same function: held against the plain backward


def variant_library(name: str, backward: bool = False):
    """The port's K3 (or its backward) rebuilt with the substitutions of
    VARIANTS[name] (BWD_VARIANTS[name])."""
    from mp_former_tpu_torch.ops import cuda_build

    file = "masked_attn_bwd.cu" if backward else "masked_attn_fwd.cu"
    # the shared building blocks inlined, so that a substitution finds its text
    source = (cuda_build.CSRC / file).read_text().replace(
        '#include "masked_attn_common.cuh"',
        (cuda_build.CSRC / "masked_attn_common.cuh").read_text().replace("#pragma once", ""))
    for old, new in (BWD_VARIANTS if backward else VARIANTS)[name]:
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
        (out_dir / file).write_text(source)
        cuda_build.compile_library([out_dir / file], out_dir, path.name)
    for line in (out_dir / "build.log").read_text().splitlines():
        if backward and ("Used" in line or "spill" in line):
            print(f"[ptxas] variant={name} {line.strip()}")
    lib = ctypes.CDLL(str(path))
    entry = file[:-3]
    getattr(lib, entry).argtypes = getattr(cuda_build.library(), entry).argtypes
    getattr(lib, entry).restype = ctypes.c_int
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


BWD_SHAPES = ((8, 120, 256), (8, 120, 1024), (8, 120, 4096), (1, 100, 13600))
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BWD_CHUNKS = (64, 128, 256, 512, 1024)


def rel_err(got, want) -> float:
    """max |got - want| relative to want's largest entry."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def backward(lib, card: str, seed: int, variants: bool = False) -> dict:
    """K3 backward: the first design, the port's, its chunk sweep and SDPA's
    backward, by device time (see the module's note); with `variants` also the
    port's kernel rebuilt with one thing changed (BWD_CHECKED_VARIANTS checked,
    the others timed only: they compute something else)."""
    import torch
    import torch.nn.functional as F

    from mp_former_tpu_torch.ops import cuda_build
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.utils.cuda_timing import device_ms

    g = torch.Generator(device="cuda").manual_seed(seed)
    H, D, DN = 8, 32, 20
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, Q, S in BWD_SHAPES:
            q, k, v = (torch.randn((B, n, H * D), generator=g, device="cuda").to(dtype)
                       .view(B, n, H, D).transpose(1, 2) for n in (Q, S, S))
            go = torch.randn((B, Q, H, D), generator=g, device="cuda").to(dtype).transpose(1, 2)
            mask = (torch.rand((B, 1, Q, S), generator=g, device="cuda") < 0.7).expand(
                B, H, Q, S).clone()
            mask[:, :, :DN] = torch.rand((B, H, DN, S), generator=g, device="cuda") < 0.9
            mask[:, :, 0] = True
            out, stats, out32 = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
            want = mac.masked_attention_backward_plain(go.float(), q.float(), k.float(),
                                                       v.float(), mask)
            gc = go.contiguous()

            def first():
                dq = torch.zeros((B, Q, H, D), dtype=torch.float32, device="cuda")
                dk = torch.empty((B, S, H, D), dtype=dtype, device="cuda")
                dv = torch.empty((B, S, H, D), dtype=dtype, device="cuda")
                delta = torch.empty((B * H * Q,), dtype=torch.float32, device="cuda")
                err = lib.masked_attn_bwd_first(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), gc.data_ptr(),
                    mask.data_ptr(), stats.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B, H, Q, S, D, *q.stride()[:3],
                    *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *gc.stride()[:3],
                    H * Q * S, Q * S, cuda_build.DTYPE_CODES[dtype],
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"masked_attn_bwd_first: cudaError {err}")
                return dq.to(dtype).transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)

            def port(chunk=None):
                return mac.masked_attn_bwd(go, q, k, v, mask, out32, stats, chunk=chunk)

            kernels = {"first": first, "port": port}
            chunks = [c for c in BWD_CHUNKS if c < S + 64]
            kernels.update({f"chunk_{c}": (lambda c=c: port(c)) for c in chunks})
            errs = {}

            def check(kname, got):
                torch.cuda.synchronize()
                errs[kname] = max(rel_err(x, w) for x, w in zip(got, want))
                if not errs[kname] <= BWD_TOL[name]:
                    raise AssertionError(f"{kname} {name} S={S}: relative error {errs[kname]} "
                                         f"above {BWD_TOL[name]}")
                if got[0][:, :, 0].abs().max().item() != 0.0:
                    raise AssertionError(f"{kname} {name} S={S}: a gradient to the q of a row "
                                         "blocked everywhere")

            for kname, fn in kernels.items():
                check(kname, fn())
            first, second = port(), port()
            deterministic = all(torch.equal(a, b) for a, b in zip(first, second))
            times = {kname: device_ms(fn, calls=10) for kname, fn in kernels.items()}
            additive = torch.zeros((B, H, Q, S), dtype=dtype, device="cuda")
            lib_mask = mask.clone()
            lib_mask[:, :, 0, 0] = False  # SDPA's backward differs on a row blocked everywhere
            additive.masked_fill_(lib_mask, -1e9)

            def sdpa(backward=False):
                leaves = [t.detach().requires_grad_(backward) for t in (q, k, v)]
                o = F.scaled_dot_product_attention(*leaves, attn_mask=additive)
                return torch.autograd.grad(o, leaves, go) if backward else o

            times["sdpa"] = (device_ms(lambda: sdpa(True), calls=10)
                             - device_ms(sdpa, calls=10))
            if variants:
                real = cuda_build.library
                try:
                    for vname in BWD_VARIANTS:
                        vlib = variant_library(vname, backward=True)
                        cuda_build.library = lambda vlib=vlib: vlib
                        if vname in BWD_CHECKED_VARIANTS:
                            check(f"variant_{vname}", port())
                        times[f"variant_{vname}"] = device_ms(port, calls=10)
                finally:
                    cuda_build.library = real
            default = mac._bwd_chunk_size(S, B * H * -(-Q // mac.BWD_MAX_ROWS), sms)
            key = f"{name} B{B}xH{H}xQ{Q}xS{S}"
            result[key] = {"ms": times, "rel_err": errs, "default_chunk": default,
                           "deterministic": deterministic}
            print(f"[masked_attn_bwd_bound] {key} default_chunk={default} "
                  f"port_bitwise_reproducible={deterministic} "
                  + " ".join(f"{n}_ms={t:.5f}" for n, t in times.items())
                  + " rel_err=" + ",".join(f"{n}:{e:.1e}" for n, e in errs.items())
                  + f" card={card!r}", flush=True)
            del q, k, v, go, gc, mask, out, stats, want, additive, lib_mask
    return result


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
    ap.add_argument("--backward", action="store_true",
                    help="time K3's backward (the first design against the port's) instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_masked_attn_bound: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.utils.cuda_timing import card_string, device_ms

    card = card_string()
    lib = probe_library()
    if args.backward:
        print(json.dumps({"card": card, "clock": "device time by CUDA graph replay",
                          "backward": backward(lib, card, args.seed, args.variants)}))
        return 0
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
