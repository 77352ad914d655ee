#!/usr/bin/env python3
"""Profile the PyTorch port's serving path on one CUDA card.

    python3 tools/profile_torch_slice.py [--recipe released|tpu] [--requests 3]
                                         [--height 480 --width 640]

Builds the released R50 COCO instance recipe (K1 and K3), or with `--recipe
tpu` the TPU recipe in float32 (head-shared sampling through K2, and K3), at
full width with seeded random weights (as `chip_smoke.py` does), warms up on
the request shape,
then traces `--requests` requests with `torch.profiler` and prints: the
card, host time per request, device busy time per request (the sum of the
kernels' device time over the traced window), the top ops by device time
and by host time, the port's own kernels (device time per launch, as the
profiler reads it from the card), and the time by model stage
(record_function ranges).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", choices=("released", "tpu"), default="released")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs a CUDA card")
    sys.path.insert(0, REPO)
    from chip_smoke import SEED, slice2_cfg, slice_cfg
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.models import build_model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = slice2_cfg() if args.recipe == "tpu" else slice_cfg()
    torch.manual_seed(SEED)
    model = build_model(cfg)
    predictor = Predictor(cfg, model=model, device="cuda")
    img = np.random.RandomState(SEED).randint(0, 256, (args.height, args.width, 3), dtype=np.uint8)
    # stage ranges for the trace
    stages = {"backbone": model.backbone, "pixel_decoder": model.sem_seg_head.pixel_decoder,
              "decoder": model.sem_seg_head.predictor}
    for name, mod in stages.items():
        fwd = mod.forward_features if name == "pixel_decoder" else mod.forward

        def wrapped(*a, _fwd=fwd, _name=name, **kw):
            with record_function(f"stage::{_name}"):
                return _fwd(*a, **kw)
        if name == "pixel_decoder":
            mod.forward_features = wrapped
        else:
            mod.forward = wrapped
    for _ in range(3):
        predictor(img)
    torch.cuda.synchronize()
    host = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.requests):
            t0 = time.perf_counter()
            with record_function("request"):
                predictor(img)
            host.append(time.perf_counter() - t0)
    events = prof.key_averages()
    # kernels and copies are device events of their own (an op's device time
    # counts its kernels again); the record_function ranges are device spans
    ranges = ("request", "stage::")
    device = [e for e in events if e.device_type.name == "CUDA" and not e.key.startswith(ranges)]
    dev_us = sum(e.self_device_time_total for e in device)
    copy_us = sum(e.self_device_time_total for e in device if e.key.startswith("Memcpy"))
    print(f"card: {card}  recipe: {args.recipe}")
    print(f"request {args.height}x{args.width}: host ms per request "
          f"{[round(t * 1e3, 2) for t in host]}")
    print(f"device busy ms per request (kernels and copies): {dev_us / 1e3 / args.requests:.3f}, "
          f"of which copies {copy_us / 1e3 / args.requests:.3f}")
    print("\n== the port's kernels ==")
    for e in device:
        if any(name in e.key for name in ("msda_fwd", "masked_attn", "tap_weight", "row_gather")):
            print(f"{e.key[:70]:70s} launches/request={e.count / args.requests:g} "
                  f"device_ms/launch={e.self_device_time_total / 1e3 / e.count:.4f} "
                  f"device_ms/request={e.self_device_time_total / 1e3 / args.requests:.4f}")
    print("\n== by device time ==")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    print("\n== stages ==")
    for e in events:
        if e.key.startswith("stage::") or e.key == "request":
            print(f"{e.key:24s} host_ms/call={e.cpu_time_total / 1e3 / e.count:.3f} "
                  f"device_span_ms/call={e.device_time_total / 1e3 / e.count:.3f} calls={e.count}")
    print("\n== by host time ==")
    print(events.table(sort_by="self_cpu_time_total", row_limit=20, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
