"""The traced run's instruments, all in the benchmark's own files: the
profiler sessions, ranges around the port's kernel entries and model parts,
and the reduction of a Chrome trace to busy time, device time by range,
idle gaps and the heaviest device operations.

A range's device time is the time of every kernel, copy and fill whose
launch the host made inside the range (matched by the trace's correlation
ids), so it reads the same whatever implements the work. A trace of the
card alone (CUDA activity only) holds no host ranges: its device work is
what the stretch's own recorded launches put on the card, and its window
runs from the first to the end of the last of those operations, so work
that an earlier unit left queued is in neither."""

from __future__ import annotations

import bisect
import importlib
import json
import os
import sys
import tempfile
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("cpu_op", "user_annotation")


class Trace:
    """A parsed Chrome trace of one profiled stretch of steps or requests."""

    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        runtime = [e for e in xs if e.get("cat") in RUNTIME_CATS]
        self.ranges = [e for e in xs if e.get("cat") in RANGE_CATS]
        steps = [e for e in self.ranges if e["name"].startswith("ProfilerStep#")]
        if not steps:
            launched = {e.get("args", {}).get("correlation") for e in runtime}
            self.device = [e for e in self.device
                           if e.get("args", {}).get("correlation") in launched]
        by_corr = defaultdict(float)
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_corr[corr] += e["dur"]
        # per host thread: launch times and the device microseconds each launched
        self._launch: Dict[int, Tuple[List[float], List[float]]] = {}
        per_tid = defaultdict(list)
        for e in runtime:
            corr = e.get("args", {}).get("correlation")
            if corr in by_corr:
                per_tid[e["tid"]].append((e["ts"], by_corr[corr]))
        for tid, rows in per_tid.items():
            rows.sort()
            self._launch[tid] = ([r[0] for r in rows], [r[1] for r in rows])
        self.runtime = runtime
        if steps:
            self.main_tid = steps[0]["tid"]
            edges = steps
        else:
            # the card alone: the launches' thread, and no ranges
            tids = Counter(e["tid"] for e in runtime)
            self.main_tid = tids.most_common(1)[0][0] if tids else None
            edges = self.device
        if not edges:
            raise ValueError("the trace holds neither a ProfilerStep range nor a launched "
                             "device operation")
        self.start = min(e["ts"] for e in edges)
        self.end = max(e["ts"] + e["dur"] for e in edges + self.device)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the window."""
        spans = sorted((max(e["ts"], self.start), min(e["ts"] + e["dur"], self.end))
                       for e in self.device)
        out: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def _range_union(self, match: Callable[[str], bool]) -> Dict[int, List[Tuple[float, float]]]:
        per_tid = defaultdict(list)
        for e in self.ranges:
            if match(e["name"]):
                per_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        out = {}
        for tid, spans in per_tid.items():
            spans.sort()
            merged: List[List[float]] = []
            for a, b in spans:
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            out[tid] = [(a, b) for a, b in merged]
        return out

    def device_s_in(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device seconds launched, from any host thread, while a range whose
        name `match`es was open (the backward's kernels are launched by
        autograd's own thread inside the main thread's range); None where no
        such range is in the trace."""
        unions = self._range_union(match)
        if not unions:
            return None
        spans = sorted(s for per_tid in unions.values() for s in per_tid)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        total = 0.0
        for times, durs in self._launch.values():
            for a, b in merged:
                lo, hi = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
                total += sum(durs[lo:hi])
        return total / 1e6

    def host_s_in(self, match: Callable[[str], bool]) -> Optional[float]:
        """Host seconds covered by the ranges whose name `match`es."""
        unions = self._range_union(match)
        if not unions:
            return None
        return sum(b - a for spans in unions.values() for a, b in spans) / 1e6

    def top_device_ops(self, n: int = 10) -> List[List]:
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e["name"]] += e["dur"] / 1e6
        return [[k[:200], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The `n` longest gaps between device work inside the window, each
        named by what the host was doing at the gap's middle: the innermost
        range its main thread was in, else the CUDA call it was in, else
        "host, no CUDA call" (a trace of the card alone has no ranges)."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        main = [e for e in self.ranges if e["tid"] == self.main_tid]
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inside = [e for e in main if e["ts"] <= mid < e["ts"] + e["dur"]] or \
                [e for e in self.runtime if e["ts"] <= mid < e["ts"] + e["dur"]]
            name = min(inside, key=lambda e: e["dur"])["name"] if inside \
                else "host, no CUDA call"
            out.append([name[:200], (b - a) / 1e6])
        return out


class Profile:
    """A `torch.profiler` session over `units` consecutive steps or requests,
    after `skip` of them, the last of which is the profiler's warm-up: call
    `step()` after each unit. With `host` False it records the card alone
    (CUDA activity: kernels, copies, fills and the launches), which leaves
    the host's own ops unrecorded and unslowed; with `host` True also the
    host's ops and ranges. No shapes, no stacks. On a CPU device it records
    the host."""

    def __init__(self, skip: int, units: int, host: bool, device_type: str = "cuda"):
        from torch.profiler import ProfilerActivity, profile, schedule

        if device_type != "cuda":
            activities = [ProfilerActivity.CPU]
        elif host:
            activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        else:
            activities = [ProfilerActivity.CUDA]
        self.units = units
        self.trace: Optional[Trace] = None
        self._seen = 0
        self._skip = skip
        self._prof = profile(activities=activities,
                             schedule=schedule(wait=max(skip - 1, 0), warmup=1 if skip else 0,
                                               active=units, repeat=1),
                             on_trace_ready=self._ready)
        self._prof.start()

    def _ready(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f)["traceEvents"])
        finally:
            os.remove(path)

    def phase(self) -> str:
        """What the profiler does in the next unit: "wait", "warm" or "record"."""
        if self._seen < self._skip - 1:
            return "wait"
        if self._seen < self._skip:
            return "warm"
        return "record" if self._seen < self._skip + self.units else "done"

    def step(self) -> None:
        self._seen += 1
        self._prof.step()
        if self.done:
            self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    @property
    def done(self) -> bool:
        return self._seen >= self._skip + self.units


# -- ranges placed from the benchmark's files ------------------------------------

class EntryCalls:
    """The calls of one kernel entry of the port made while `active`: each
    call's least time forward (`forward`) and, where its backward ran, the
    backward's (`backward`), from the benchmark's count of its bytes and
    operations; and the names of the autograd nodes that ran its backward.
    `wrap_entry` places it."""

    def __init__(self, key: str, cost: Callable):
        self.key, self.cost = key, cost
        self.active = False
        self.forward: List = []
        self.backward: List = []
        self.nodes = set()

    def range_name(self) -> str:
        return f"bench::{self.key}"


def wrap_entry(target: str, calls: EntryCalls, package: str) -> Callable[[], None]:
    """Replace the function `module:name` of `target` wherever a module of
    `package` holds it by name, by one that runs it inside the range
    `bench::<key>` and records its cost while `calls.active`; returns a
    function that puts the original back."""
    modname, fname = target.split(":")
    fn = getattr(importlib.import_module(modname), fname)

    def wrapped(*args, **kwargs):
        if not calls.active:
            return fn(*args, **kwargs)
        with torch.profiler.record_function(calls.range_name()):
            out = fn(*args, **kwargs)
        fwd, bwd = calls.cost(*args, **kwargs)
        calls.forward.append(fwd)
        node = out.grad_fn if isinstance(out, torch.Tensor) else None
        if node is not None and bwd is not None:
            calls.nodes.add(node.name())

            def ran(_grads, _bwd=bwd):
                if calls.active:
                    calls.backward.append(_bwd)

            node.register_prehook(ran)
        return out

    patched = []
    for name, module in list(sys.modules.items()):
        if (name == package or name.startswith(package + ".")) and module is not None \
                and getattr(module, fname, None) is fn:
            setattr(module, fname, wrapped)
            patched.append(module)

    def restore() -> None:
        for module in patched:
            setattr(module, fname, fn)

    return restore
