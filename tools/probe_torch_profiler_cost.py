#!/usr/bin/env python3
"""What `torch.profiler` costs the host on one training step, on one CUDA card.

    python3 tools/probe_torch_profiler_cost.py [--mode points] [--repeats 2]

Builds the released recipe's model at `chip_smoke.py`'s training batch (8
images of 512x512, the DN modes' settings) from its seeded init and warms
it with three steps. Then it profiles one step at a time, alternately with
host and device activities and with the device alone. For each it prints
the seconds of the profiled block, of `key_averages()` and the device busy
ms (`utils/cuda_timing.py:device_busy_us`). Last it profiles a step each way
and prints the device keys whose time differs most between the two, so
that one can see which events only the host's trace adds. Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="points", help="MODEL.MASK_FORMER.DN_MODE")
    p.add_argument("--repeats", type=int, default=2)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.utils.cuda_timing import device_busy_us

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cs.phase_build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(REPO, "output", "probe_profiler_cost")
    cfg = cs.load_cfg(cs.CONFIG, [*cs.DN_MODES_OVERRIDES, "MODEL.MASK_FORMER.DN_MODE", args.mode,
                                  "MODEL.MASK_FORMER.HEAD_DN", "True", "OUTPUT_DIR", out_dir])
    batches = synthetic_batches(cs.TRAIN_BATCH, cs.TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                cs.TRAIN_MAX_INSTANCES, seed=cs.SEED)
    trainer = Trainer(cfg, batches, model=cs.seeded_model(torch, cfg), device="cuda")
    for _ in range(3):
        trainer.run_step(next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run_step(next(batches))
    torch.cuda.synchronize()
    print(f"step without the profiler {time.perf_counter() - t0:.3f} s", flush=True)

    ways = {"host+device": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
            "device": [ProfilerActivity.CUDA]}

    def profiled(activities):
        with profile(activities=activities) as prof:
            trainer.run_step(next(batches))
            torch.cuda.synchronize()
        return prof

    for _ in range(args.repeats):
        for name, activities in ways.items():
            t0 = time.perf_counter()
            prof = profiled(activities)
            t1 = time.perf_counter()
            events = prof.key_averages()
            t2 = time.perf_counter()
            print(f"{name}: profiled block {t1 - t0:.3f} s, key_averages {t2 - t1:.3f} s, "
                  f"device busy {device_busy_us(events) / 1e3:.3f} ms, keys {len(events)}",
                  flush=True)

    def device_keys(activities):
        return {(e.key, bool(getattr(e, "is_user_annotation", False))):
                (e.self_device_time_total, e.count)
                for e in profiled(activities).key_averages() if e.device_type.name == "CUDA"}

    both, device = device_keys(ways["host+device"]), device_keys(ways["device"])
    rows = sorted(((device.get(k, (0, 0))[0] - both.get(k, (0, 0))[0], k) for k in {*both, *device}),
                  key=lambda r: -abs(r[0]))
    for diff, (key, annotation) in rows[:20]:
        (tb, nb), (td, nd) = both.get((key, annotation), (0, 0)), device.get((key, annotation), (0, 0))
        print(f"device - host+device {diff / 1e3:+.3f} ms: {key[:90]!r} user annotation "
              f"{annotation}; host+device {tb / 1e3:.3f} ms x{nb}, device {td / 1e3:.3f} ms x{nd}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
