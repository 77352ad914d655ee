#!/usr/bin/env python3
"""What bounds deformable sampling's backward (K1 backward) on one CUDA card.

    python3 tools/probe_torch_msda_bwd_bound.py [--seed 0]

At the training shape (B = 8, a 512x512 image: levels 16x16, 32x32, 64x64,
Q = S = 5376) and at one 800x1088 canvas (B = 1, Q = S = 17850), M8 D32 P4,
every token a query, by device time (CUDA graph replay), on four sets of
sampling locations:

  uniform    anywhere on the map and a little off it (no locality at all);
  model      each query's reference point plus the compass-rose offsets of a
             freshly initialised `MSDeformAttn` (tools/probe_torch_msda_bound.py);
  noisy      as `chip_smoke.py` makes them: a few pixels off the reference point
             at random, 2% of the points far off the map;
  one_pixel  every point of a level on that level's middle pixel.

The kernels: the port's (`csrc/msda_bwd.cu`, `port`: 16 consecutive queries a
block, every tap a 16-byte float32 atomic a lane); a rejected design kept in
`tools/probe_torch_msda_bwd_binned.cu` (`binned`: 8 x 8 tiles of tokens a
block, the taps near the tile binned by pixel in shared memory and added once a
pixel; `binned_unstaged`: the same tiles, every tap added at once). Then both
rebuilt with one thing changed each time (a textual substitution in the
source; the tool raises if one no longer applies). PORT_VARIANTS, timed in
float32 on all four sets of locations: its atomics replaced by plain stores
(`port_stores`: a wrong result, the ceiling of what any regrouping of the adds
could win short of adding less), 4 x 4 tiles of tokens a block (`port_tiles`)
and both (`port_tiles_stores`), 8 blocks an SM by launch bounds, no adds to
grad_value at all (`port_no_adds`: a wrong result, the floor of everything but
the adds). BINNED_VARIANTS, timed on the `noisy` and `model` locations: the
binning without its final sums, without sorting and sums, its shared memory
reserved but unused, no adds outside the windows. Each kernel that computes
the whole function (`port`, `binned`, `binned_unstaged`, PORT_CHECKED_VARIANTS)
is first held against the plain backward (grad_value and grad_attn relative to
their largest entry, 1e-4 in float32, 1e-2 in bfloat16; grad_loc off by more on
at most 1e-5 of its entries); bfloat16 is timed for `port` on the `noisy`
locations.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BINNED_SOURCE = Path(__file__).with_name("probe_torch_msda_bwd_binned.cu")
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
CASES = {"train": (8, [(16, 16), (32, 32), (64, 64)]),
         "canvas": (1, [(25, 34), (50, 68), (100, 136)])}
KINDS = ("uniform", "model", "noisy", "one_pixel")
BINNED_TILE = 8
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
    """name -> [(text in csrc/msda_bwd.cu, its replacement)]; `tiles`: the 4 x 4
    tiles of tokens of one (batch, head), the sum over levels of
    ceil(H / 4) * ceil(W / 4)."""
    tiled = [("const int query_blocks = (Q + kQueriesPerBlock - 1) / kQueriesPerBlock;",
              f"const int query_blocks = {tiles};"),
             ("  const int q = (blockIdx.x % query_blocks) * kQueriesPerBlock + threadIdx.x / "
              "kLanes;\n  const bool live = q < Q;", TILE_MAP),
             ("const long long blocks = (long long)B * M * ((Q + kQueriesPerBlock - 1) / "
              "kQueriesPerBlock);", f"const long long blocks = (long long)B * M * {tiles};")]
    return {"stores": [(ADD, STORE)],
            "tiles": tiled,
            "tiles_stores": tiled + [(ADD, STORE)],
            "eight_blocks_per_sm": [("__launch_bounds__(kThreads)",
                                     "__launch_bounds__(kThreads, 8)")],
            "no_adds": [(ADD, "")]}


PORT_CHECKED_VARIANTS = ("tiles", "eight_blocks_per_sm")  # the same function
BINNED_VARIANTS = {
    "no_gather": [("for (int k = slot; k < touched; k += kQueries) {",
                   "for (int k = slot; k < 0; k += kQueries) {")],
    "no_sort": [("for (int k = slot; k < touched; k += kQueries) {",
                 "for (int k = slot; k < 0; k += kQueries) {"),
                ("  for (int r = tid; r < records; r += kThreads) {",
                 "  for (int r = tid; r < 0; r += kThreads) {")],
    "smem_reserved": [("const int smem = windows ? binned_bytes(kQueries * L * P * 4) : 0;",
                       "const int smem = binned_bytes(kQueries * L * P * 4);")],
    "no_adds": [("  if (w != 0.f)\n    atomicAdd(", "  if (false)\n    atomicAdd(")],
}


def block_queries(spatial_shapes, Q: int):
    """The binned kernel's map from a block to its queries within one (batch,
    head): per block its 64 query slots (-1 for a slot without a query). Where
    the queries are the tokens (Q = S) the blocks take 8 x 8 tiles of tokens,
    level after level, row after row of tiles, the slots row-major within the
    tile; otherwise 64 consecutive queries."""
    S = sum(h * w for h, w in spatial_shapes)
    slots = BINNED_TILE * BINNED_TILE
    if Q != S:
        return [[q if q < Q else -1 for q in range(first, first + slots)]
                for first in range(0, Q, slots)]
    blocks, start = [], 0
    for h, w in spatial_shapes:
        for ty in range(-(-h // BINNED_TILE)):
            for tx in range(-(-w // BINNED_TILE)):
                block = []
                for i in range(slots):
                    x, y = tx * BINNED_TILE + i % BINNED_TILE, ty * BINNED_TILE + i // BINNED_TILE
                    block.append(start + y * w + x if x < w and y < h else -1)
                blocks.append(block)
        start += h * w
    return blocks


def build(sources, name: str):
    """Compile `sources` into a library of the build tree, once per content."""
    from mp_former_tpu_torch.ops import cuda_build

    digest = hashlib.sha256(b"".join(src.read_bytes() for src in sources)).hexdigest()[:16]
    out_dir = cuda_build.BUILD_ROOT / f"probe_msda_bwd_{name}_{digest}"
    path = out_dir / "libmsda_bwd_probe.so"
    if not path.is_file():
        cuda_build.compile_library(list(sources), out_dir, path.name)
    for line in (out_dir / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {name} {line.strip()}")
    return ctypes.CDLL(str(path))


def probe_library():
    """The binned design, beside the port's kernels."""
    lib = build([BINNED_SOURCE], "binned")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msda_bwd_binned.argtypes = [p] * 8 + [i] * 11 + [p]
    lib.msda_bwd_binned.restype = i
    return lib


def variant_library(source: Path, subs, name: str, entry: str, argtypes):
    """`source` rebuilt with the substitutions `subs`."""
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
    lib = ctypes.CDLL(str(path))
    getattr(lib, entry).argtypes = argtypes
    getattr(lib, entry).restype = ctypes.c_int
    return lib


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_msda_bwd_bound: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from mp_former_tpu_torch.ops import cuda_build, msda_cuda
    from mp_former_tpu_torch.ops.cuda_build import DTYPE_CODES
    from mp_former_tpu_torch.utils.cuda_timing import card_string, device_ms

    card = card_string()
    lib = probe_library()
    M, D, P = 8, 32, 4
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": card, "clock": "device time by CUDA graph replay", "ms": {}}
    for case, (B, shapes) in CASES.items():
        L = len(shapes)
        S = sum(h * w for h, w in shapes)
        tiles4 = sum(-(-h // 4) * -(-w // 4) for h, w in shapes)
        tiles8 = len(block_queries(shapes, S))
        value = torch.randn((B, S, M, D), generator=g, device="cuda")
        attn = torch.randn((B, S, M, L * P), generator=g, device="cuda").softmax(-1)
        attn = attn.view(B, S, M, L, P)
        grad_out = torch.randn((B, S, M * D), generator=g, device="cuda")
        levels = msda_cuda._level_table(tuple(shapes), torch.device("cuda"))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            go, v, a = (t.to(dtype).contiguous() for t in (grad_out, value, attn))

            def binned(loc, stage=1, fn=None):
                grad_value = torch.zeros((B, S, M, D), dtype=torch.float32, device="cuda")
                grad_loc, grad_attn = torch.empty_like(loc), torch.empty_like(a)
                err = (fn or lib.msda_bwd_binned)(
                    go.data_ptr(), v.data_ptr(), levels.data_ptr(), loc.data_ptr(), a.data_ptr(),
                    grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(), B, S, S,
                    M, L, P, D, tiles8, 1, stage, DTYPE_CODES[dtype],
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"msda_bwd_binned: cudaError {err}")
                return grad_value.to(dtype), grad_loc, grad_attn

            def port(loc):
                return msda_cuda.msda_bwd(go, v, shapes, loc, a)

            kernels = {"port": port}
            if dtype == torch.float32:
                kernels["binned"] = binned
                kernels["binned_unstaged"] = lambda loc: binned(loc, stage=0)
            kinds = KINDS if dtype == torch.float32 else ("noisy",)
            locs = {kind: locations(torch, kind, B, shapes, M, P, g).to(dtype) for kind in kinds}
            want = msda_cuda.ms_deform_attn_backward_plain(go.float(), v.float(), shapes,
                                                           locs["noisy"].float(), a.float())
            errs = {}

            def check(kname, got):
                torch.cuda.synchronize()
                # grad_value and grad_attn relative to their largest entry; grad_loc
                # may jump where the two roundings put a point on either side of a
                # pixel border (chip_smoke.py's rule): a share of entries
                errs[kname] = max(((x.float() - w).abs().max() / w.abs().max()).item()
                                  for x, w in zip(got[::2], want[::2]))
                loc_off = ((got[1].float() - want[1]).abs()
                           > TOL[name] * want[1].abs().max()).float().mean().item()
                if not (errs[kname] <= TOL[name] and loc_off <= 1e-5):
                    raise AssertionError(f"{kname} {case} {name}: relative error {errs[kname]} "
                                         f"above {TOL[name]}, or grad_loc off on {loc_off}")

            for kname, fn in kernels.items():
                check(kname, fn(locs["noisy"]))
            times = {kname: {kind: device_ms(lambda: fn(loc), calls=10)
                             for kind, loc in locs.items()} for kname, fn in kernels.items()}
            if dtype == torch.float32:
                real = cuda_build.library
                try:
                    for vname, subs in port_variants(tiles4).items():
                        vlib = variant_library(cuda_build.CSRC / "msda_bwd.cu", subs,
                                               f"port_{vname}", "msda_bwd",
                                               real().msda_bwd.argtypes)
                        cuda_build.library = lambda vlib=vlib: vlib
                        if vname in PORT_CHECKED_VARIANTS:
                            check(f"port_{vname}", port(locs["noisy"]))
                        times[f"port_{vname}"] = {kind: device_ms(lambda: port(loc), calls=10)
                                                  for kind, loc in locs.items()}
                finally:
                    cuda_build.library = real
                for vname, subs in BINNED_VARIANTS.items():
                    vfn = variant_library(BINNED_SOURCE, subs, f"binned_{vname}",
                                          "msda_bwd_binned",
                                          lib.msda_bwd_binned.argtypes).msda_bwd_binned
                    times[f"binned_{vname}"] = {
                        kind: device_ms(lambda: binned(locs[kind], fn=vfn), calls=10)
                        for kind in ("noisy", "model")}
            del want
            key = f"{case} {name} B{B}xQ{S}xM{M}xD{D}xL{L}xP{P}"
            result["ms"][key] = times
            for kname, by_kind in times.items():
                print(f"[msda_bwd_bound] {key} kernel={kname} "
                      + " ".join(f"{kind}_ms={t:.4f}" for kind, t in by_kind.items())
                      + (f" rel_err={errs[kname]:.1e}" if kname in errs else "")
                      + f" card={card!r}", flush=True)
            del locs
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
