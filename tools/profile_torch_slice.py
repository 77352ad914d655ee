#!/usr/bin/env python3
"""Profile the PyTorch port's serving path, or its training step, on one CUDA card.

    python3 tools/profile_torch_slice.py [--recipe released|tpu] [--requests 3]
                                         [--height 480 --width 640]
    python3 tools/profile_torch_slice.py --train [--requests 3]
    python3 tools/profile_torch_slice.py --train-inputs [--requests 3]

Builds the released R50 COCO instance recipe (K1 and K3), or with `--recipe
tpu` the TPU recipe in float32 (head-shared sampling through K2, and K3), at
full width with seeded random weights (as `chip_smoke.py` does), warms up on
the request shape,
then traces `--requests` requests with `torch.profiler` and prints: the
card, host time per request, device busy time per request (the sum of the
kernels' device time over the traced window), the top ops by device time
and by host time, the port's own kernels (device time per launch, as the
profiler reads it from the card; K3 is two kernels where the keys are split,
`masked_attn_tiles` and `masked_attn_merge`), the number of strided-to-contiguous
copy kernels per request, and the time by model stage (record_function ranges).

`--train` profiles the training step of `chip_smoke.py`'s train phase instead
(the released training recipe at full width and depth, B = 8 images of 512x512
from the seeded generator, float32, TF32 off): after 2 warm steps it times
`--requests` steps stage by stage on the host clock with a synchronise after
each stage (forward, matcher costs, the host's assignment solve, losses,
backward, clipping and optimizer), then traces as many steps with
`torch.profiler` and prints device busy time per step, the port's four kernels
per launch and the top ops by device time.

`--train-inputs` asks where the step of `chip_smoke.py`'s `train_coco` phase
(the same recipe fed by `build_train_loader` from its dataset on disk: LSJ,
100 target slots, ground truth at 1/4 of the canvas, pinned batches) spends
more than phase `train`'s: it runs the step on ten batch sources in turns,
`--requests` steps each for 3 rounds, and prints each source's seconds per
step (`Trainer.run_step`, synchronised), the matcher's host time and the
stages with a synchronise after each. The sources differ one thing at a time:
`generated20` phase train's batches (20 slots, full-resolution masks,
pageable), `generated20_s4` their masks any-pooled to 1/4, `generated100_s4`
those padded to 100 slots, `loader_prefetched` loader batches taken before
the timing (no worker thread maps while a step runs), `loader_live` the loader
mapping the next batches on its threads meanwhile, `loader_live_1worker` a
loader with one worker thread, `loader_live_1thread` the first loader while
torch's intra-op pool has one thread, `loader_live_switch` the first loader
while the interpreter hands the GIL between threads every 0.1 ms, not every
5 ms (`sys.setswitchinterval`): where the main thread waits for a GIL that a
mapper thread holds, that wait shrinks; `loader_live_pageable` a loader that
does not pin its batches; `prefetched_busy_native` batches taken beforehand
while 4 threads hash in C with the GIL released (cores taken, GIL free).
While each source's steps run, a thread that sleeps 1 ms at a time records
how late it wakes: the time it waits for the GIL, and for a core, once its
sleep ends. Then it splits the
evaluation of the phase's 8 val images into the `Predictor` call and the
evaluator's `process`.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


STAGES = ("forward", "matcher_costs", "matcher_host", "losses", "backward", "optimizer")


def train_step_in_stages(torch, trainer, batch, between):
    """`engine/train_step.py:train_step` with `between(stage)` called as a
    context around each stage."""
    model, criterion = trainer.model, trainer.criterion
    targets = batch.targets
    num_masks = targets.valid.sum().float().clamp(min=1.0)
    with between("forward"):
        outputs = model(batch.images, targets, generator=trainer.generator)
    with between("matcher_costs"):
        costs = criterion.layer_costs(outputs, targets, trainer.generator)
        costs = costs.cpu()
    with between("matcher_host"):
        assignments = criterion.assign(costs).to(batch.images.device)
    with between("losses"):
        losses = criterion(outputs, targets, trainer.generator, num_masks=num_masks,
                           assignments=assignments)
        total = criterion.weighted_total(losses)
    with between("backward"):
        trainer.optimizer.zero_grad(set_to_none=True)
        total.backward()
    with between("optimizer"):
        if trainer.clip_gradients is not None:
            trainer.clip_gradients([p for g in trainer.optimizer.param_groups
                                    for p in g["params"]])
        trainer.optimizer.step()
        trainer.scheduler.step()
    return total


def profile_training(torch, card: str, steps: int) -> int:
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import (CONFIG, SEED, TRAIN_BATCH, TRAIN_MAX_INSTANCES, TRAIN_OVERRIDES,
                            TRAIN_SIZE, load_cfg, seeded_model)
    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer

    cfg = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "OUTPUT_DIR",
                            os.path.join(REPO, "output", "profile_train")])
    batches = synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                TRAIN_MAX_INSTANCES, seed=SEED)
    trainer = Trainer(cfg, batches, model=seeded_model(torch, cfg), device="cuda")
    for _ in range(2):
        trainer.run_step(next(batches))
    torch.cuda.synchronize()

    seconds = {s: [] for s in STAGES}

    @contextlib.contextmanager
    def synchronised(stage):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        seconds[stage].append(time.perf_counter() - t0)

    whole = []
    for _ in range(steps):
        batch = next(batches).to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step_in_stages(torch, trainer, batch, synchronised)
        whole.append(time.perf_counter() - t0)
    plain = []
    for _ in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_step(batch)
        torch.cuda.synchronize()
        plain.append(time.perf_counter() - t0)
    print(f"card: {card}  training step, B={TRAIN_BATCH} at {TRAIN_SIZE}x{TRAIN_SIZE}, float32, "
          "TF32 off")
    print(f"step seconds, Trainer.run_step (batch copy included): {[round(t, 4) for t in plain]}")
    print(f"step seconds with a synchronise after every stage: {[round(t, 4) for t in whole]}")
    for stage in STAGES:
        mean = sum(seconds[stage]) / steps
        print(f"  {stage:14s} {mean * 1e3:8.2f} ms  "
              f"({100 * mean * steps / sum(whole):4.1f}% of the synchronised step)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            batch = next(batches).to("cuda")
            with record_function("step"):
                train_step_in_stages(torch, trainer, batch,
                                     lambda stage: record_function(f"stage::{stage}"))
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranges = ("step", "stage::")
    device = [e for e in events if e.device_type.name == "CUDA" and not e.key.startswith(ranges)]
    dev_us = sum(e.self_device_time_total for e in device)
    print(f"\ndevice busy ms per step (kernels and copies): {dev_us / 1e3 / steps:.2f}")
    print("\n== the port's kernels ==")
    for e in device:
        if any(name in e.key for name in ("msda_fwd", "msda_bwd", "masked_attn", "tap_weight")):
            print(f"{e.key[:70]:70s} launches/step={e.count / steps:g} "
                  f"device_ms/launch={e.self_device_time_total / 1e3 / e.count:.4f} "
                  f"device_ms/step={e.self_device_time_total / 1e3 / steps:.4f}")
    print("\n== by device time ==")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    print("\n== stages (host time to issue, device span) ==")
    for e in events:
        if e.key.startswith(ranges):
            print(f"{e.key:24s} host_ms/call={e.cpu_time_total / 1e3 / e.count:.3f} "
                  f"device_span_ms/call={e.device_time_total / 1e3 / e.count:.3f} calls={e.count}")
    return 0


def compare_train_inputs(torch, card: str, steps: int, rounds: int = 3) -> int:
    import contextlib
    import hashlib
    import itertools
    import threading

    import torch.nn.functional as F

    from chip_smoke import (COCO_ROOT, CONFIG, SEED, TRAIN_BATCH, TRAIN_MAX_INSTANCES,
                            TRAIN_OVERRIDES, TRAIN_SIZE, load_cfg, seeded_model, write_coco)
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.data.datasets.coco import register_all_coco
    from mp_former_tpu_torch.data.loader import build_train_loader
    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.eval_loop import read_image
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.evaluation.build import build_evaluator
    from mp_former_tpu_torch.structures import Batch, Targets

    write_coco(COCO_ROOT)
    register_all_coco(COCO_ROOT)
    cfg = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "INPUT.IMAGE_SIZE", str(TRAIN_SIZE), "OUTPUT_DIR",
                            os.path.join(REPO, "output", "profile_train_inputs")])
    trainer = Trainer(cfg, model=seeded_model(torch, cfg), device="cuda")

    def strided(b: Batch, slots: int) -> Batch:
        """Masks any-pooled to 1/4 and the targets padded to `slots`."""
        t = b.targets
        masks = F.max_pool2d(t.masks.float(), 4) > 0
        pad = slots - t.labels.shape[1]

        def grow(x):
            return torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))], 1)
        return Batch(b.images, Targets(grow(t.labels), grow(masks), grow(t.boxes), grow(t.valid)))

    generated = synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                  TRAIN_MAX_INSTANCES, seed=SEED)
    live = build_train_loader(cfg, pin_memory=True)
    one_worker = cfg.clone()
    one_worker.defrost()
    one_worker.DATALOADER.NUM_WORKERS = 1
    live1 = build_train_loader(one_worker, pin_memory=True)
    live_pageable = build_train_loader(cfg)
    n_pre = (steps + 1) * rounds + 2
    prefetched = [next(live) for _ in range(2 * n_pre)]
    data_s = {}

    def from_live(name, loader):
        data_s[name] = []
        while True:
            t0 = time.perf_counter()
            b = next(loader)
            data_s[name].append(time.perf_counter() - t0)
            yield b

    sources = {"generated20": generated,
               "generated20_s4": (strided(b, TRAIN_MAX_INSTANCES) for b in generated),
               "generated100_s4": (strided(b, cfg.TPU.MAX_INSTANCES) for b in generated),
               "loader_prefetched": iter(prefetched[:n_pre]),
               "prefetched_busy_native": iter(prefetched[n_pre:]),
               "loader_live": from_live("loader_live", live),
               "loader_live_1worker": from_live("loader_live_1worker", live1),
               "loader_live_1thread": from_live("loader_live_1thread", live),
               "loader_live_switch": from_live("loader_live_switch", live),
               "loader_live_pageable": from_live("loader_live_pageable", live_pageable)}
    # the same loader while torch's CPU ops (the mapper's resize among them)
    # run on one thread of the intra-op pool, or while the GIL changes hands
    # every 0.1 ms; loader batches while 4 threads keep 4 cores busy in C
    # without the GIL
    intra_op = {"loader_live_1thread": 1}
    switch = {"loader_live_switch": 1e-4}
    busy = {"prefetched_busy_native": 4}
    threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    late_s = {k: [] for k in sources}

    def hashing(stop):
        data = os.urandom(1 << 22)
        while not stop.is_set():
            hashlib.sha256(data).digest()  # releases the GIL for the whole hash

    def sampling(stop, late):
        while not stop.is_set():
            t0 = time.perf_counter()
            time.sleep(1e-3)
            late.append(time.perf_counter() - t0 - 1e-3)

    @contextlib.contextmanager
    def conditions(name, probe):
        torch.set_num_threads(intra_op.get(name, threads))
        sys.setswitchinterval(switch.get(name, interval))
        stop = threading.Event()
        workers = [threading.Thread(target=hashing, args=(stop,), daemon=True)
                   for _ in range(busy.get(name, 0))]
        if probe:
            workers.append(threading.Thread(target=sampling, args=(stop, late_s[name]),
                                            daemon=True))
        for w in workers:
            w.start()
        try:
            yield
        finally:
            stop.set()
            for w in workers:
                w.join()
            torch.set_num_threads(threads)
            sys.setswitchinterval(interval)

    for name, src in sources.items():  # warm-up: two steps of each
        with conditions(name, probe=False):
            for _ in range(2):
                trainer.run_step(next(src))
    torch.cuda.synchronize()
    step_s = {k: [] for k in sources}
    host_s = {k: 0.0 for k in sources}
    stage_s = {k: {s: [] for s in STAGES} for k in sources}
    for _ in range(rounds):
        for name, src in sources.items():
            h0 = trainer.criterion.matcher_host_seconds
            with conditions(name, probe=True):
                for _ in range(steps):
                    batch = next(src)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.run_step(batch)
                    torch.cuda.synchronize()
                    step_s[name].append(time.perf_counter() - t0)
            host_s[name] += trainer.criterion.matcher_host_seconds - h0

            @contextlib.contextmanager
            def synchronised(stage, _name=name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                yield
                torch.cuda.synchronize()
                stage_s[_name][stage].append(time.perf_counter() - t0)

            with conditions(name, probe=False):
                train_step_in_stages(torch, trainer, next(src).to("cuda", non_blocking=True),
                                     synchronised)
    print(f"card: {card}  training step, B={TRAIN_BATCH} at {TRAIN_SIZE}x{TRAIN_SIZE}, float32, "
          f"TF32 off; {steps} steps x {rounds} rounds a source, in turns; torch intra-op "
          f"threads {threads}, CPU cores {os.cpu_count()}, GIL switch interval {interval} s")
    for name in sources:
        t = sorted(step_s[name])
        stages = "  ".join(f"{s}={1e3 * sum(v) / len(v):.1f}" for s, v in stage_s[name].items())
        print(f"{name:20s} s/step mean={sum(t) / len(t):.4f} median={t[len(t) // 2]:.4f} "
              f"min={t[0]:.4f} max={t[-1]:.4f}  matcher_host_ms/step="
              f"{1e3 * host_s[name] / len(t):.2f}")
        print(f"{'':20s} synchronised stages (ms): {stages}")
        late = sorted(late_s[name])
        print(f"{'':20s} 1 ms sleeper wakes late (ms): mean={1e3 * sum(late) / len(late):.3f} "
              f"p90={1e3 * late[int(0.9 * len(late))]:.3f} "
              f"p99={1e3 * late[int(0.99 * len(late))]:.3f} max={1e3 * late[-1]:.3f} "
              f"over {len(late)} sleeps")
    for name, waits in data_s.items():
        print(f"{name} data wait per step (s): mean={sum(waits) / max(len(waits), 1):.4f} "
              f"max={max(waits, default=0.0):.4f} over {len(waits)}")
    for loader in (live, live1, live_pageable):
        loader.close()

    records = DatasetCatalog.get("coco_2017_val")
    evset = build_evaluator(cfg, "coco_2017_val", records)
    predictor = Predictor(cfg, model=trainer.model, device="cuda")
    pred_s, proc_s = [], []
    with torch.no_grad():
        for rec in itertools.chain(records[:2], records):  # 2 warm-up images
            image = read_image(rec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inst = predictor(image, (rec["height"], rec["width"]))["instances"]
            t1 = time.perf_counter()
            evset.process(rec, {"instance": (inst["scores"], inst["classes"], inst["masks"])})
            pred_s.append(t1 - t0)
            proc_s.append(time.perf_counter() - t1)
    pred_s, proc_s = pred_s[2:], proc_s[2:]
    print(f"evaluation of {len(records)} val images of {records[0]['height']}x"
          f"{records[0]['width']}: Predictor s/image={sum(pred_s) / len(pred_s):.4f} "
          f"(instances to the host included), evaluator process s/image="
          f"{sum(proc_s) / len(proc_s):.4f}")
    return 0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="profile the training step instead of serving")
    ap.add_argument("--train-inputs", action="store_true",
                    help="the training step on ten batch sources, loader-fed among them")
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
    if args.train:
        return profile_training(torch, card, args.requests)
    if args.train_inputs:
        return compare_train_inputs(torch, card, args.requests)
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
    # strided-to-contiguous copies (`.contiguous()`, `.to`, `copy_`) run as
    # direct_copy kernels; K3 reads the head views where they lie, so the
    # decoder's 18 copies of K and V per request are not among them
    copies = [e for e in device if "direct_copy_kernel" in e.key]
    print(f"\ndirect_copy kernels: launches/request={sum(e.count for e in copies) / args.requests:g} "
          f"device_ms/request={sum(e.self_device_time_total for e in copies) / 1e3 / args.requests:.4f}")
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
