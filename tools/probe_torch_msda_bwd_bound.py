#!/usr/bin/env python3
"""What bounds deformable sampling's backward (K1 backward) on one CUDA card,
and the port's design against the window-stationary one in one run.

    python3 tools/probe_torch_msda_bwd_bound.py [--seed 0] [--cases train,canvas,bs16]
                                                [--kernels port,windows,mma,...] [--sass]
                                                [--out msda_bwd_probe.json]

Every token a query (Q = S), M8 D32 P4, by device time (CUDA graph replay), at
three shapes: the training step's (`train`: B = 8, a 512x512 image, levels
16x16, 32x32, 64x64), one 800x1088 canvas (`canvas`: B = 1, Q = S = 17850)
and the released batch's (`bs16`: B = 16, 1024x1024, levels 32x32, 64x64,
128x128); in float32 and in the bfloat16 model's mix (bfloat16 value and
gradient, float32 locations and weights); on four sets of sampling locations:

  uniform    anywhere on the map and a little off it (no locality at all);
  model      each query's reference point plus the compass-rose offsets of a
             freshly initialised `MSDeformAttn` (tools/probe_torch_msda_bound.py);
  noisy      as `chip_smoke.py` makes them: a few pixels off the reference point
             at random, 2% of the points far off the map;
  one_pixel  every point of a level on that level's middle pixel.

The kernels: the port's (`csrc/msda_bwd.cu`, `port`: 16 consecutive queries
a block, 8 lanes a query, every tap a 16-byte float32 atomic a lane into the
L2); the window-stationary design (`tools/probe_torch_msda_bwd_windows.cu`,
`windows`: a block a tile of the image on every level and a head, the taps
inside the block's windows summed in shared memory and flushed once); its
tensor-core form (`tools/probe_torch_msda_bwd_mma.cu`, `mma`: the same block
map and windows, a scalar a tap into A (window pixels x the block's queries),
grad_window = A G and D = V Gᵀ by mma.sync in 3xTF32). Then the kernels
rebuilt with one thing changed (a textual substitution in the source; the
tool raises if one no longer applies). MMA_VARIANTS: one TF32 term a
product in place of three (`mma_one_term`, not float32's accuracy: bounds
the split's cost); no tensor-core product at all (`mma_no_products`, a wrong
result: bounds the rest, the zeroing, scatter, barriers and reads).
WINDOWS_VARIANTS: the windows off, every tap straight to grad_value with the
same block map (`windows_windows_off`); one block of 1024 threads an SM with
twice the shared memory (`windows_one_block`); that, with value's windows
staged in shared memory and read from there (`windows_staged`); each window
pixel row flushed by one bulk reduce-add copy of the copy engine
(`windows_bulk_flush`); the adds into a window by PTX `red.shared.add.f32`
(`windows_red_ptx`); two floats a 64-bit compare-and-swap loop
(`windows_cas64`); and two that compute a wrong result and bound the parts:
no add into the windows (`windows_no_window_adds`), no add at all
(`windows_no_adds`). PORT_VARIANTS: plain stores in place of its atomics
(`port_stores`), 4 x 4 tiles of tokens a block (`port_tiles`), no adds
(`port_no_adds`). Each kernel that computes the whole function is first held
against the plain backward at each shape and type, on the `noisy` locations
(grad_value and grad_attn relative to their largest entry, 1e-4 in float32,
1e-2 in bfloat16; grad_loc off by more on at most 1e-5 of its entries). The
share of the adds that fall inside a window is the mirror's
(`window_tap_share` of `tools/probe_torch_msda_bwd_windows.py`), on the same
locations. A kernel that fails its hold is said so and not timed, and the
tool then exits 1. `--kernels` keeps the named kernels (and `port`);
`--sass` prints, per built library and kernel, the count of each atomic,
reduction and tensor-core instruction in its SASS (cuobjdump).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WINDOWS_SOURCE = Path(__file__).with_name("probe_torch_msda_bwd_windows.cu")
MMA_SOURCE = Path(__file__).with_name("probe_torch_msda_bwd_mma.cu")
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
CASES = {"train": (8, [(16, 16), (32, 32), (64, 64)]),
         "canvas": (1, [(25, 34), (50, 68), (100, 136)]),
         "bs16": (16, [(32, 32), (64, 64), (128, 128)])}
KINDS = ("uniform", "model", "noisy", "one_pixel")
# the adds to grad_value in csrc/msda_bwd.cu
ADD = ("  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g.x, w * g.y, w * g.z, "
       "w * g.w));")
STORE = "  *reinterpret_cast<float4*>(p) = make_float4(w * g.x, w * g.y, w * g.z, w * g.w);"
# a block's 16 queries: a 4 x 4 tile of tokens of one level instead of 16
# consecutive ones (the queries are the tokens); `query_blocks` tiles a (batch, head)
TILE_MAP = """  int q = 0;
  bool live = false;
  {  // a 4 x 4 tile of tokens of one level
    const int blk = blockIdx.x % query_blocks, slot = threadIdx.x / kLanes;
    int first = 0;
    for (int l = 0; l < L; ++l) {
      const int H = s_levels[3 * l], W = s_levels[3 * l + 1], tw = (W + 3) / 4;
      const int n = tw * ((H + 3) / 4);
      if (blk < first + n) {
        const int x = ((blk - first) % tw) * 4 + slot % 4, y = ((blk - first) / tw) * 4 + slot / 4;
        live = x < W && y < H;
        q = s_levels[3 * l + 2] + y * W + x;
        break;
      }
      first += n;
    }
  }"""


def port_variants(tiles: int) -> dict:
    """name -> [(text in csrc/msda_bwd.cu, its replacement)];
    `tiles`: the 4 x 4 tiles of tokens of one (batch, head), the sum over
    levels of ceil(H / 4) * ceil(W / 4)."""
    tiled = [("const int query_blocks = (Q + kQueriesPerBlock - 1) / kQueriesPerBlock;",
              f"const int query_blocks = {tiles};"),
             ("  const int q = (blockIdx.x % query_blocks) * kQueriesPerBlock + threadIdx.x / "
              "kLanes;\n  const bool live = q < Q;", TILE_MAP),
             ("const long long blocks = (long long)B * M * ((Q + kQueriesPerBlock - 1) / "
              "kQueriesPerBlock);", f"const long long blocks = (long long)B * M * {tiles};")]
    return {"stores": [(ADD, STORE)], "tiles": tiled, "no_adds": [(ADD, "")]}


PORT_CHECKED = ("tiles",)  # the variants that compute the same function
ONE_BLOCK = [("constexpr int kThreads = 512;", "constexpr int kThreads = 1024;"),
             ("constexpr int kBlocksPerSm = 2;", "constexpr int kBlocksPerSm = 1;"),
             ("constexpr int kSmemBytes = 110 * 1024;", "constexpr int kSmemBytes = 220 * 1024;")]
# p[0] += x, p[1] += y in shared memory by one 64-bit compare-and-swap loop
CAS64_ADD = """__device__ __forceinline__ void shared_add(float* p, float x) { atomicAdd(p, x); }
__device__ __forceinline__ void shared_add2(float* p, float x, float y) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *a, seen;
  do {
    seen = old;
    const float lo = __uint_as_float((unsigned)seen) + x;
    const float hi = __uint_as_float((unsigned)(seen >> 32)) + y;
    old = atomicCAS(a, seen, ((unsigned long long)__float_as_uint(hi) << 32) |
                                 __float_as_uint(lo));
  } while (old != seen);
}"""
WINDOWS_VARIANTS = {
    "windows_off": [("constexpr bool kWindows = true;", "constexpr bool kWindows = false;")],
    "one_block": ONE_BLOCK,
    "staged": ONE_BLOCK + [("constexpr bool kStageValue = false;",
                            "constexpr bool kStageValue = true;")],
    "bulk_flush": [("constexpr bool kBulkFlush = false;", "constexpr bool kBulkFlush = true;")],
    # the adds into a window by the PTX reduction instead of atomicAdd (which
    # the compiler makes a compare-and-swap loop on shared memory)
    "red_ptx": [("{ atomicAdd(p, x); }",
                 '{ asm volatile("red.shared.add.f32 [%0], %1;" :: "r"((unsigned)'
                 '__cvta_generic_to_shared(p)), "f"(x) : "memory"); }')],
    # two floats a compare-and-swap (64-bit) instead of one: half the loops
    "cas64": [("__device__ __forceinline__ void shared_add(float* p, float x) { atomicAdd(p, x); }",
               CAS64_ADD),
              ("""        shared_add(p + rot, w * r0);
        shared_add(p + ((rot + 1) & 3), w * r1);
        shared_add(p + ((rot + 2) & 3), w * r2);
        shared_add(p + ((rot + 3) & 3), w * r3);""",
               """        const int h0 = (rot & 1) * 2, h1 = h0 ^ 2;  // the lane's two pairs, rotated
        shared_add2(p + h0, w * (h0 ? g.z : g.x), w * (h0 ? g.w : g.y));
        shared_add2(p + h1, w * (h1 ? g.z : g.x), w * (h1 ? g.w : g.y));""")],
    "no_window_adds": [("          window_add(s, w);", "          ;")],
    "no_adds": [("          window_add(s, w);", "          ;"),
                ("          atomic_add_vec(gbase + o, w, g);", "          ;")],
}
WINDOWS_CHECKED = ("windows_off", "one_block", "staged", "bulk_flush", "red_ptx", "cas64")
MMA_ASM = """  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));"""
MMA_VARIANTS = {
    "one_term": [("constexpr bool kSplit = true;", "constexpr bool kSplit = false;")],
    # no tensor-core product at all: grad_window and D stay 0 (wrong), and the
    # compiler drops the fragments' loads and splits with them
    "no_products": [(MMA_ASM, "  (void)c; (void)a; (void)b0; (void)b1;")],
}
SASS_OPS = re.compile(r"\b(ATOMS|ATOMG|ATOM|RED|REDG|HMMA)(\.[A-Z0-9_.]+)?")


def sass_counts(path: Path) -> dict:
    """kernel name -> {instruction: count} of the atomics, reductions and
    tensor-core instructions in the SASS of the library at `path`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        out[name] = dict(collections.Counter(a + b for a, b in SASS_OPS.findall(block)))
    return out


def build_variant(source: Path, subs, name: str, entry: str):
    """`source` rebuilt with the substitutions `subs` into a library of the
    build tree, once per content; returns its entry point and the library."""
    from mp_former_tpu_torch.ops import cuda_build

    text = source.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} no longer stands once in {source.name}")
        text = text.replace(old, new)
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    out_dir = cuda_build.BUILD_ROOT / f"probe_msda_bwd_{name}_{digest}"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "libmsda_bwd_variant.so"
    if not path.is_file():
        (out_dir / source.name).write_text(text)
        cuda_build.compile_library([out_dir / source.name], out_dir, path.name)
    for line in (out_dir / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"[ptxas] variant={name} {line.strip()}")
    fn = getattr(ctypes.CDLL(str(path)), entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 8 + [p]
    fn.restype = i
    return fn, path


def caller(torch, fn, shapes):
    """A call of the entry point `fn` (the arguments of `msda_bwd`) as the
    port's wrapper makes it: grad_value zeroed, the outputs allocated."""
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops.cuda_build import DTYPE_CODES

    levels = msda_cuda._level_table(tuple(shapes), torch.device("cuda"))

    def call(go, v, loc, a):
        B, S, M, D = v.shape
        Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
        grad_value = torch.zeros((B, S, M, D), dtype=torch.float32, device="cuda")
        grad_loc, grad_attn = torch.empty_like(loc), torch.empty_like(a)
        code = 2 if loc.dtype != v.dtype else DTYPE_CODES[v.dtype]
        err = fn(go.data_ptr(), v.data_ptr(), levels.data_ptr(), loc.data_ptr(), a.data_ptr(),
                 grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(), B, S, Q, M,
                 L, P, D, code, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"msda_bwd variant: cudaError {err}")
        return grad_value.to(v.dtype), grad_loc, grad_attn
    return call


def locations(torch, kind: str, B: int, shapes, M: int, P: int, generator):
    """(B, S, M, L, P, 2) sampling locations of one `kind` (see the module's note)."""
    from mp_former_tpu_torch.models.pixel_decoder.msdeformattn import _reference_points
    from mp_former_tpu_torch.ops.ms_deform_attn import MSDeformAttn

    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    sizes = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                         device="cuda").view(1, 1, 1, L, 1, 2)
    ref = _reference_points(shapes, "cuda")[None, :, None, :, None, :]   # (1, S, 1, L, 1, 2)
    if kind == "uniform":
        return torch.rand((B, S, M, L, P, 2), generator=generator, device="cuda") * 1.2 - 0.1
    if kind == "model":
        bias = MSDeformAttn(M * 32, L, M, P).sampling_offsets.bias.detach().to("cuda")
        loc = ref + bias.view(1, 1, M, L, P, 2) / sizes
        return loc.expand(B, S, M, L, P, 2).contiguous()
    if kind == "noisy":
        offsets = torch.randn((B, S, M, L, P, 2), generator=generator, device="cuda") * 3.0
        loc = ref + offsets / sizes
        far = torch.rand((B, S, M, L, P, 1), generator=generator, device="cuda") < 0.02
        return torch.where(far, loc + 2.0, loc).contiguous()
    if kind == "one_pixel":
        centre = torch.tensor([[(w // 2 + 0.5) / w, (h // 2 + 0.5) / h] for h, w in shapes],
                              dtype=torch.float32, device="cuda")
        return centre.view(1, 1, 1, L, 1, 2).expand(B, S, M, L, P, 2).contiguous()
    raise ValueError(kind)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--kernels", default="", help="only these kernels (and port), comma-separated")
    ap.add_argument("--sass", action="store_true", help="print the SASS instruction counts")
    ap.add_argument("--out", default="", help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_msda_bwd_bound: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from mp_former_tpu_torch.ops import cuda_build, msda_cuda
    from probe_torch_msda_bwd_windows import window_tap_share
    from mp_former_tpu_torch.utils.cuda_timing import card_string, device_ms

    card = card_string()
    M, D, P = 8, 32, 4
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": card, "clock": "device time by CUDA graph replay", "ms": {},
              "share_in_window": {}, "rel_err": {}, "failed": {}, "sass": {}}
    cases = args.cases.split(",")
    # every library built side by side: (source, substitutions, name, entry)
    builds = {"windows": (WINDOWS_SOURCE, [], "windows", "msda_bwd_windows"),
              "mma": (MMA_SOURCE, [], "mma", "msda_bwd_mma")}
    for vname, subs in WINDOWS_VARIANTS.items():
        builds[f"windows_{vname}"] = (WINDOWS_SOURCE, subs, f"windows_{vname}",
                                      "msda_bwd_windows")
    for vname, subs in MMA_VARIANTS.items():
        builds[f"mma_{vname}"] = (MMA_SOURCE, subs, f"mma_{vname}", "msda_bwd_mma")
    for case in cases:
        tiles4 = sum(-(-h // 4) * -(-w // 4) for h, w in CASES[case][1])
        for vname, subs in port_variants(tiles4).items():
            # only the tiles depend on the case
            key = (case, f"port_{vname}") if vname == "tiles" else f"port_{vname}"
            builds[key] = (cuda_build.CSRC / "msda_bwd.cu", subs, f"port_{vname}", "msda_bwd")
    if args.kernels:
        keep = set(args.kernels.split(","))
        builds = {k: b for k, b in builds.items()
                  if (k[1] if isinstance(k, tuple) else k) in keep}
    def build(b):
        try:
            return build_variant(*b)
        except RuntimeError as err:  # a variant that does not build is left out, said so
            print(f"[msda_bwd_bound] variant {b[2]} did not build: {str(err)[-2000:]}")
            return None

    with ThreadPoolExecutor(len(builds) + 1) as pool:
        port = pool.submit(cuda_build.library)
        built = {k: fp for k, fp in zip(builds, pool.map(build, builds.values()))
                 if fp is not None}
        port = port.result().msda_bwd
    if args.sass:
        libs = {"port": cuda_build.build(), **{(k if isinstance(k, str) else "_".join(k)): p
                                               for k, (_, p) in built.items()}}
        for lname, path in libs.items():
            for fname, ops in sass_counts(path).items():
                if "msda_bwd" in fname:
                    result["sass"][f"{lname} {fname}"] = ops
                    print(f"[msda_bwd_bound] sass library={lname} kernel={fname[:100]} {ops}",
                          flush=True)
    built = {k: fn for k, (fn, _) in built.items()}
    for case in cases:
        B, shapes = CASES[case]
        L = len(shapes)
        S = sum(h * w for h, w in shapes)
        kernels = {"port": port}
        for name, fn in built.items():
            if isinstance(name, str):
                kernels[name] = fn
            elif name[0] == case:
                kernels[name[1]] = fn
        checked = [k for k in ["port", "windows", "mma"]
                   + [f"windows_{v}" for v in WINDOWS_CHECKED]
                   + [f"port_{v}" for v in PORT_CHECKED] if k in kernels]
        value = torch.randn((B, S, M, D), generator=g, device="cuda")
        attn = torch.randn((B, S, M, L * P), generator=g, device="cuda").softmax(-1)
        attn = attn.view(B, S, M, L, P)
        grad_out = torch.randn((B, S, M * D), generator=g, device="cuda")
        locs = {kind: locations(torch, kind, B, shapes, M, P, g) for kind in KINDS}
        result["share_in_window"][case] = {
            kind: window_tap_share(shapes, loc, attn) for kind, loc in locs.items()}
        print(f"[msda_bwd_bound] {case} share of adds inside a window "
              + " ".join(f"{k}={v:.4f}" for k, v in result["share_in_window"][case].items()),
              flush=True)
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            # float32, and the bfloat16 model's mix: bfloat16 value and gradient
            go, v = (t.to(dtype).contiguous() for t in (grad_out, value))
            want = msda_cuda.ms_deform_attn_backward_plain(go.float(), v.float(), shapes,
                                                           locs["noisy"], attn)
            mix = "/float32" if name != "float32" else ""
            key = f"{case} {name}{mix} B{B}xQ{S}xM{M}xD{D}xL{L}xP{P}"
            calls = {k: caller(torch, fn, shapes) for k, fn in kernels.items()}
            errs, failed = {}, []
            for kname in checked:
                got = calls[kname](go, v, locs["noisy"], attn)
                torch.cuda.synchronize()
                # grad_value and grad_attn relative to their largest entry; grad_loc
                # may jump where the two roundings put a point on either side of a
                # pixel border (chip_smoke.py's rule): a share of entries
                errs[kname] = max(((x.float() - w).abs().max() / w.abs().max()).item()
                                  for x, w in zip(got[::2], want[::2]))
                loc_off = ((got[1].float() - want[1]).abs()
                           > TOL[name] * want[1].abs().max()).float().mean().item()
                del got
                if not (errs[kname] <= TOL[name] and loc_off <= 1e-5):
                    failed.append(kname)
                    result["failed"][f"{key} {kname}"] = [errs[kname], loc_off]
                    print(f"[msda_bwd_bound] FAILED {kname} {key}: relative error {errs[kname]} "
                          f"above {TOL[name]}, or grad_loc off on {loc_off}", flush=True)
            del want
            times = {}
            for kname, call in calls.items():
                if kname in failed:
                    continue
                # one_pixel: every add of a level on one row, fewer calls a graph
                times[kname] = {kind: device_ms(lambda: call(go, v, loc, attn),
                                                calls=2 if kind == "one_pixel" else 10)
                                for kind, loc in locs.items()}
                print(f"[msda_bwd_bound] {key} kernel={kname} "
                      + " ".join(f"{kind}_ms={t:.4f}" for kind, t in times[kname].items())
                      + (f" rel_err={errs[kname]:.1e}" if kname in errs else "")
                      + f" card={card!r}", flush=True)
            result["ms"][key] = times
            result["rel_err"][key] = errs
        del locs, value, attn, grad_out
        torch.cuda.empty_cache()
    print(json.dumps(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
