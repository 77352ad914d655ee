#!/usr/bin/env python3
"""Row-gather rate of the port's hand-written gather kernels on one CUDA card.

    python3 tools/probe_torch_row_gather.py [--iters 50] [--seed 0]

The counterpart of the JAX package's three row-gather probes, at their
shapes: P1 gathers 64 rows of a 256x128 float32 table, P2 gathers 65536 rows
of a 16641x128 float32 table and sums them into 8 slots without writing them
out, P3 gathers 1024 rows of an Rx128 table (R = 101 * 137, the patch table of
a 100x136 level) in float32 and bfloat16. Those probes first asked whether
the compiler could lower a gather at all; on this card that is not in
question, so this tool checks each kernel against its plain version and
prints its time per row, beside `torch.index_select` (for the sum:
`F.embedding_bag`) on the same inputs and beside the card's name and power
limit. Every time is read on two clocks: `ms` is device time (the calls
captured into a CUDA graph and replayed), `issue_ms` the host's time to issue
one eager call. At these sizes the second is the larger, and is what an eager
caller pays.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (table rows, row width, gathered rows, dtype, slots; 0 = plain gather)
PROBES = {
    "P1": (256, 128, 64, "float32", 0),
    "P2": (16641, 128, 65536, "float32", 8),
    "P3": (101 * 137, 128, 1024, "float32", 0),
    "P3_bf16": (101 * 137, 128, 1024, "bfloat16", 0),
}
# the sum adds 8192 rows of magnitude ~1 per output in another order than
# the plain version, in float32: a few ulp of a sum of magnitude ~100
SUM_TOL = 1e-2


def run_probes(card: str, seed: int = 0, iters: int = 50):
    """Run every probe once against its plain version, then time it; returns
    one dict per probe. Raises if a kernel disagrees."""
    import torch
    import torch.nn.functional as F

    from mp_former_tpu_torch.ops import row_gather as rg
    from mp_former_tpu_torch.utils.cuda_timing import two_clocks

    g = torch.Generator(device="cuda").manual_seed(seed)
    results = []
    for name, (rows, width, n, dtype_name, slots) in PROBES.items():
        dtype = getattr(torch, dtype_name)
        tab = torch.randn((rows, width), generator=g, device="cuda").to(dtype)
        idx = torch.randint(0, rows, (n,), generator=g, device="cuda", dtype=torch.int32)
        if slots:
            op, tol = "row_gather_sum", SUM_TOL
            kernel = lambda: rg.row_gather_sum(tab, idx, slots)
            plain = lambda: rg.row_gather_sum_plain(tab, idx, slots)
            bags = idx.view(-1, slots).t().contiguous()  # bag s = the rows of slot s
            library = lambda: F.embedding_bag(bags, tab, mode="sum")
        else:
            op, tol = "row_gather", 0.0
            kernel = lambda: rg.row_gather(tab, idx)
            plain = lambda: rg.row_gather_plain(tab, idx)
            library = lambda: torch.index_select(tab, 0, idx)
        got, want, lib = kernel(), plain(), library()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (lib.float() - want.float()).abs().max().item()
        if got.shape != want.shape or got.dtype != want.dtype or not err <= tol:
            raise AssertionError(f"{name} {op}: max abs error {err} above {tol} "
                                 f"(shapes {tuple(got.shape)} / {tuple(want.shape)})")
        if not lib_err <= SUM_TOL:
            raise AssertionError(f"{name}: the library call computes another function "
                                 f"(max abs error {lib_err})")
        k, pl, lb = (two_clocks(fn, iters=iters) for fn in (kernel, plain, library))
        res = {"probe": name, "op": op, "rows": rows, "width": width, "n": n,
               "dtype": dtype_name, "slots": slots, "element_size": tab.element_size(),
               "index_size": idx.element_size(), "max_abs_err": err, "tol": tol,
               "ms": k["ms"], "issue_ms": k["issue_ms"],
               "plain_ms": pl["ms"], "plain_issue_ms": pl["issue_ms"],
               "library_ms": lb["ms"], "library_issue_ms": lb["issue_ms"]}
        print(f"[row_gather] {name} {op} tab={rows}x{width} {dtype_name} n={n} slots={slots} "
              f"max_abs_err={err:.3e} tol={tol} kernel_ms={k['ms']:.5f} "
              f"kernel_issue_ms={k['issue_ms']:.5f} kernel_ns_per_row={k['ms'] * 1e6 / n:.3f} "
              f"plain_ms={pl['ms']:.5f} plain_issue_ms={pl['issue_ms']:.5f} "
              f"library_ms={lb['ms']:.5f} library_issue_ms={lb['issue_ms']:.5f} "
              f"library_ns_per_row={lb['ms'] * 1e6 / n:.3f} "
              f"card={card!r}", flush=True)
        results.append(res)
    return results


def sweep_sum_blocks(card: str, seed: int = 0) -> None:
    """Device time of `row_gather_sum` at P2's shape for each number of rows a
    block owns (fewer rows: more blocks and more atomic additions per output)."""
    import torch

    from mp_former_tpu_torch.ops import row_gather as rg
    from mp_former_tpu_torch.utils.cuda_timing import device_ms

    rows, width, n, _, slots = PROBES["P2"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    tab = torch.randn((rows, width), generator=g, device="cuda")
    idx = torch.randint(0, rows, (n,), generator=g, device="cuda", dtype=torch.int32)
    times = {per_block: device_ms(lambda: rg.row_gather_sum_fwd(tab, idx, slots, per_block))
             for per_block in (64, 128, 256, 512, 1024, 2048)}
    print("[row_gather] P2 row_gather_sum rows_per_block sweep "
          + " ".join(f"{k}:{v:.5f}ms" for k, v in times.items()) + f" card={card!r}", flush=True)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true",
                    help="also time row_gather_sum at P2 over the rows a block owns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_row_gather: needs a CUDA card")
    sys.path.insert(0, REPO)
    from mp_former_tpu_torch.utils.cuda_timing import card_string

    card = card_string()
    run_probes(card, args.seed, args.iters)
    if args.sweep:
        sweep_sum_blocks(card, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
