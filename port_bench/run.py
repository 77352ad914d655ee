"""The port's benchmark: one cell, one seed, one run.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`workloads/<cell>.json`) names a configuration (`configs/<name>.json`)
and a traffic kind (`traffic/<kind>.py`) with its parameters. The traffic
kind sets the program up, warms it, drives it for `--seconds`, and checks
what it produced against the plain reference (`reference/`). With `--trace
1` two profiled stretches of the window and its unprofiled units give the
per-layer metrics (`common.Instruments`), each read by
the reader that its file in `metrics/` names. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`,
`device`, in a traced run `breakdown`, and last `checks`, each number
compared beside its limit, which also end standard error.

Runs only on a CUDA card and beside the program: without either it exits
with 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import spec  # noqa: E402

# the package under test
PROGRAM = "mp_former_tpu_torch"
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mp_former_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in list(modules) if name.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths: the
    port builds its kernels into `build/torch_kernels/` of the checkout by
    itself; Triton and torch's extension builds go beside it."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def cuda_ready(chips: int) -> Optional[str]:
    """None where torch sees at least `chips` CUDA cards, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards and torch sees {torch.cuda.device_count()}"
    return None


def program_missing() -> Optional[str]:
    """None where the program under test can be imported from the checkout."""
    if importlib.util.find_spec(PROGRAM) is None:
        return f"the program {PROGRAM} is not in the checkout"
    return None


def run_cell(cell: "spec.Cell") -> Dict:
    """Set up, warm, measure, check; the result's fields (no printing)."""
    traffic = spec.traffic_module(cell.workload["traffic"])
    outcome = traffic.run(cell)
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed}
    if cell.trace:
        metrics = {}
        for name, m in spec.metrics_for(cell).items():
            value = spec.reader_module(m["reader"]).read(outcome.readings, **m.get("args", {}))
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in outcome.metrics.items()}
    result["device"] = outcome.device
    t = outcome.readings.device_trace if cell.trace and outcome.readings is not None else None
    if t is not None:
        # the stretch traced on the card alone
        result["device"]["busy_s"] = t.busy_s
        result["device"]["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.top_device_ops(), "idle_gaps": t.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.Cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    set_cache_dirs(ROOT)
    why = cuda_ready(cell.chips) or program_missing()
    if why is not None:
        print(f"port_bench: {why}; it runs on CUDA cards beside the program: no result",
              file=sys.stderr)
        return 2
    result = run_cell(cell)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}; it may load none of "
              f"{', '.join(FORBIDDEN)}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
