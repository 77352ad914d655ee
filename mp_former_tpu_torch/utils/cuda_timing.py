"""Timing on a CUDA card, for the measuring scripts (`chip_smoke.py`,
`tools/probe_torch_row_gather.py`, `tools/probe_torch_msda_bound.py`).

A call has two clocks. `device_ms` is what the card spends on it: a run of
calls is captured into a CUDA graph and replayed, so the host issues nothing
while the events run. `issue_ms` is what the host spends to issue one eager
call (Python, checks, allocation, launch). An eager caller pays the larger of
the two. `cuda_ms` (events around a loop of eager calls) reads that larger
one, whichever it is. `busy_ms` is a whole path's device busy time (a
request, a training step): its kernels' and copies' time, idle gaps left out.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict

import torch


def card_string() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (first card): it goes beside every
    measured number, since a card set below its full power limit runs slower."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() in ms by CUDA events around `iters` eager calls: the
    device time where that is above the host's issue time, else the issue
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn: Callable[[], object], calls: int = 20) -> float:
    """Mean device time of fn() in ms: `calls` calls captured into one CUDA
    graph (after a warm-up on a side stream, as capture asks), the graph
    replayed once untimed and then 5 times between two events. fn must be fit
    for capture: it launches on the current stream, allocates through PyTorch
    and never synchronises. Raises if the capture fails."""
    warmup, replays = 3, 5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


def issue_ms(fn: Callable[[], object], iters: int = 50) -> float:
    """Host time in ms to issue one eager fn(): `time.perf_counter` around a
    loop of `iters` calls, read before the one synchronise that ends it (the
    device starts empty, so the host never waits for it unless a call does);
    the best of three loops, since the host's cores are shared."""
    best = float("inf")
    for _ in range(3):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best * 1e3 / iters


def two_clocks(fn: Callable[[], object], calls: int = 20, iters: int = 50) -> Dict[str, float]:
    """{"ms": device time by graph replay, "issue_ms": host issue time}."""
    return {"ms": device_ms(fn, calls=calls), "issue_ms": issue_ms(fn, iters=iters)}


def busy_ms(fn: Callable[[], object], calls: int = 3) -> float:
    """Device busy time of one call: the card's own time for every kernel and
    copy the call issued, summed (`torch.profiler`'s device events), idle
    gaps left out; one warm call first. Only the device is traced: the host's
    operator events would add no device time and cost `key_averages` about
    5 s more on a training step (NVIDIA H100 80GB HBM3)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return device_busy_us(prof.key_averages()) / 1e3 / calls


def device_busy_us(events) -> float:
    """The card's busy time in `torch.profiler` key averages: the device time
    of every kernel and copy, summed. A `record_function` range (such as
    `engine/train_step.py`'s `stage::<name>`) shows on the card as a span
    over its kernels, not as time of its own: left out."""
    return sum(e.self_device_time_total for e in events
               if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("stage::"))
