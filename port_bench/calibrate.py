"""Readings from which a cell's limits are set, in one process: the numbers
compared (`checks`) of the program on `--seeds` and of the control (the
program in `TPU.COMPUTE_DTYPE bfloat16`, the precision below the
configuration's float32) on `--control-seeds`, each a short window at the
cell's own load. Not part of a benchmark run.

    python3 -m port_bench.calibrate --workload <cell> --seconds 5 \
        --seeds 1,2,3 --control-seeds 4,5,6 [--out readings.jsonl]

Prints one JSON line a run: seed, variant, correct, every number the check
worked out (compared or not), and the end-to-end metrics."""

from __future__ import annotations

import argparse
import json
import sys
import time

from port_bench import run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--variant", default="control")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    run.set_cache_dirs(run.ROOT)
    why = run.cuda_ready(1)
    if why is not None:
        print(f"port_bench.calibrate: {why}", file=sys.stderr)
        return 2
    plan = [(int(s), None) for s in args.seeds.split(",") if s] + \
        [(int(s), args.variant) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    for seed, variant in plan:
        cell = spec.Cell(args.workload, seed, args.seconds, False, time.perf_counter(),
                         variant=variant)
        try:
            o = spec.traffic_module(cell.workload["traffic"]).run(cell)
            line = {"seed": seed, "variant": variant, "correct": o.correct,
                    "numbers": o.numbers, "metrics": {k: v for k, (v, _) in o.metrics.items()}}
        except Exception as e:  # a control that crashes has failed
            line = {"seed": seed, "variant": variant, "error": repr(e)[:500]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
