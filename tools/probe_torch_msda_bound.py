#!/usr/bin/env python3
"""What bounds deformable sampling (K1) on one CUDA card.

    python3 tools/probe_torch_msda_bound.py [--seed 0] [--height 800 --width 1088]

Times three kernels on three sets of sampling locations, all at the shape of
one encoder layer of the R50 recipe (levels at 1/32, 1/16 and 1/8 of the
canvas, every pixel a query, M8 D32 P4, float32), by device time (CUDA graph
replay). The kernels: the port's K1 (`csrc/msda_fwd.cu`) and the two probe
kernels of `tools/probe_torch_msda_bound.cu`, one warp per (query, head) with
the scalar work repeated by every lane (`per_lane`) or done once and shuffled
(`hoisted`). The locations:

  uniform    anywhere on the map and a little off it (no locality at all);
  model      each query's own reference point plus the compass-rose offsets of
             a freshly initialised `MSDeformAttn` (a few pixels from the query,
             neighbouring queries in neighbouring warps);
  one_pixel  every point of a level on that level's middle pixel (every tap is
             in the L1 after the first).

If a kernel takes the same time on all three, the caches do not bound it and
instruction issue does; if `one_pixel` is much faster, the cache path does.
Each kernel is first held against the plain version on the uniform locations.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PROBE_SOURCE = Path(__file__).with_suffix(".cu")
TOL = 1e-4  # float32: other summation order, a few ulp of outputs of magnitude ~1


def probe_library():
    """Build `tools/probe_torch_msda_bound.cu` beside the port's kernels."""
    from mp_former_tpu_torch.ops import cuda_build

    digest = hashlib.sha256(PROBE_SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = cuda_build.BUILD_ROOT / f"probe_msda_{digest}"
    path = out_dir / "libmsda_probe.so"
    if not path.is_file():
        cuda_build.compile_library([PROBE_SOURCE], out_dir, path.name)
    for line in (out_dir / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msda_probe.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.msda_probe.restype = i
    return lib


def locations(torch, kind: str, shapes, M: int, P: int, generator):
    """(1, S, M, L, P, 2) sampling locations of one `kind` (see the module's note)."""
    from mp_former_tpu_torch.models.pixel_decoder.msdeformattn import _reference_points
    from mp_former_tpu_torch.ops.ms_deform_attn import MSDeformAttn

    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    if kind == "uniform":
        return torch.rand((1, S, M, L, P, 2), generator=generator, device="cuda") * 1.2 - 0.1
    if kind == "model":
        ref = _reference_points(shapes, "cuda")[None]                       # (1, S, L, 2)
        bias = MSDeformAttn(M * 32, L, M, P).sampling_offsets.bias.detach()
        offsets = bias.view(1, 1, M, L, P, 2).to("cuda")
        normalizer = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                                  device="cuda")
        return (ref[:, :, None, :, None, :]
                + offsets / normalizer[None, None, None, :, None, :]).contiguous()
    if kind == "one_pixel":
        centre = torch.tensor([[(w // 2 + 0.5) / w, (h // 2 + 0.5) / h] for h, w in shapes],
                              dtype=torch.float32, device="cuda")
        return centre.view(1, 1, 1, L, 1, 2).expand(1, S, M, L, P, 2).contiguous()
    raise ValueError(kind)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--width", type=int, default=1088)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_msda_bound: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.utils.cuda_timing import card_string, device_ms

    card = card_string()
    lib = probe_library()
    M, D, P = 8, 32, 4
    shapes = [(args.height // s, args.width // s) for s in (32, 16, 8)]
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    value = torch.randn((1, S, M, D), generator=g, device="cuda")
    attn = torch.randn((1, S, M, L * P), generator=g, device="cuda").softmax(-1)
    attn = attn.view(1, S, M, L, P)
    shapes_t = torch.tensor(shapes, dtype=torch.int64, device="cuda")
    starts = [0]
    for h, w in shapes[:-1]:
        starts.append(starts[-1] + h * w)
    starts_t = torch.tensor(starts, dtype=torch.int64, device="cuda")

    def probe(variant: int, loc):
        out = torch.empty((1, S, M * D), dtype=torch.float32, device="cuda")
        err = lib.msda_probe(value.data_ptr(), shapes_t.data_ptr(), starts_t.data_ptr(),
                             loc.data_ptr(), attn.data_ptr(), out.data_ptr(), 1, S, S, M, L, P,
                             variant, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"msda_probe variant {variant}: cudaError {err}")
        return out

    kernels = {"K1": lambda loc: msda_cuda.msda_fwd(value, shapes, loc, attn),
               "per_lane": lambda loc: probe(0, loc),
               "hoisted": lambda loc: probe(1, loc)}
    locs = {kind: locations(torch, kind, shapes, M, P, g)
            for kind in ("uniform", "model", "one_pixel")}
    want = msda_cuda.ms_deform_attn_plain(value, shapes, locs["uniform"], attn)
    result = {"card": card, "shape": f"B1xQ{S}xM{M}xD{D}xL{L}xP{P}", "levels": shapes,
              "clock": "device time by CUDA graph replay", "ms": {}}
    for name, fn in kernels.items():
        err = (fn(locs["uniform"]) - want).abs().max().item()
        torch.cuda.synchronize()
        if not err <= TOL:
            raise AssertionError(f"{name}: max abs error {err} above {TOL}")
        # twice round, so that a drift of the card's clocks would show
        times = {kind: [device_ms(lambda: fn(loc)) for _ in range(2)]
                 for kind, loc in locs.items()}
        result["ms"][name] = {kind: min(t) for kind, t in times.items()}
        print(f"[msda_bound] kernel={name} max_abs_err={err:.3e} tol={TOL} "
              + " ".join(f"{kind}_ms={t[0]:.4f},{t[1]:.4f}" for kind, t in times.items())
              + f" card={card!r}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
