"""What the traffic kinds share: the program's model with the benchmark's
seeded weights, the reference's, float32 with TF32 off for the reference,
the device fields of the result, and what a traced run hands its readers."""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import weights
from .trace import EntryCalls, Profile, wrap_entry

PORT = "mp_former_tpu_torch"
# the port's kernel entries that the roofline shares wrap, with the count of
# a call's bytes and operations (`costs.py`)
ENTRIES = {"k1": "mp_former_tpu_torch.ops.ms_deform_attn:ms_deform_attn",
           "k3": "mp_former_tpu_torch.ops.masked_attention_cuda:masked_attention"}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_shapes(cell):
    """The reference model on the meta device: names and shapes alone."""
    from .reference.models import build_model

    with torch.device("meta"):
        return build_model(cell.reference_cfg())


def seeded_weights(cell, device: torch.device) -> Dict[str, torch.Tensor]:
    return weights.make_weights(reference_shapes(cell), cell.seed, device)


def program_model(cell, cfg, device: torch.device) -> torch.nn.Module:
    """The port's model of `cfg`, built on `device`, with the seeded weights."""
    from mp_former_tpu_torch.models import build_model

    with torch.device(device):
        model = build_model(cfg)
    model.to(device)
    weights.load(model, seeded_weights(cell, device))
    return model


def reference_model(cell, device: torch.device) -> torch.nn.Module:
    from .reference.models import build_model

    with torch.device(device):
        model = build_model(cell.reference_cfg())
    model.to(device)
    weights.load(model, seeded_weights(cell, device))
    return model


@contextlib.contextmanager
def float32_exact():
    """TF32 off in cuBLAS and cuDNN, as the reference computes."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def device_fields(device: torch.device, peak_bytes: int, chips: int) -> Dict:
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def peak_reset(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


class Readings:
    """What a traced run hands the per-layer readers. From the stretch traced
    on the card alone: its parsed trace (`device_trace`), its unit count and
    the FLOPs the benchmark counted for those units. From the stretch traced
    on host and card: its trace (`range_trace`), its unit count and the
    kernel entries' calls. From the units that no profiler touched: the host
    spans and the program's counters, a list of one value a unit (`spans`),
    and each unit's seconds by what profiled it (`unit_s`)."""

    def __init__(self):
        self.device_trace = None
        self.device_units = 0
        self.flops: Optional[float] = None
        self.range_trace = None
        self.range_units = 0
        self.entries: Dict[str, EntryCalls] = {}
        self.spans: Dict[str, List[float]] = {}
        self.unit_s: Dict[str, List[float]] = {}

    def pace(self) -> str:
        """Each kind of unit's median seconds, so a run shows what its
        profiling costs."""
        return ", ".join(f"{k} {statistics.median(v):.6f} s ({len(v)})"
                         for k, v in sorted(self.unit_s.items()) if v)


class Instruments:
    """A traced run's instruments; nothing where not traced. After `skip`
    units of the window, the last of which warms the profiler, `device_units`
    units are traced on the card alone; after one more unit of warm-up,
    `range_units` units are traced on host and card with the kernel entries
    and the model parts in ranges. Every other unit runs with no profiler and
    gives the host spans (`add_span`, the host's clock)."""

    def __init__(self, traced: bool, skip: int, device_units: int, range_units: int,
                 device_type: str = "cuda"):
        from . import costs

        self.readings = Readings() if traced else None
        self._profile: Optional[Profile] = None
        self._restore = []
        self._skip, self._units = max(skip, 1), (device_units, range_units)
        self._device_type = device_type
        self._stretch = 0
        self._open: Dict[str, float] = {}
        self._t = 0.0
        if traced:
            for key, target in ENTRIES.items():
                calls = EntryCalls(key, getattr(costs, key))
                self.readings.entries[key] = calls
                self._restore.append(wrap_entry(target, calls, PORT))

    def start(self) -> None:
        if self.readings is not None:
            self._profile = Profile(self._skip, self._units[0], host=False,
                                    device_type=self._device_type)
            self._set_active()
        self._t = now()

    @property
    def phase(self) -> str:
        """What profiles the next unit: "plain" (nothing), "warm", "device"
        (the card alone) or "ranges" (host and card)."""
        if self._profile is None:
            return "plain"
        p = self._profile.phase()
        if p == "record":
            return ("device", "ranges")[self._stretch]
        return "warm" if p == "warm" else "plain"

    def _set_active(self) -> None:
        ranging = self.phase == "ranges"
        for calls in self.readings.entries.values():
            calls.active = ranging

    def add_span(self, name: str, seconds: float) -> None:
        """Add host seconds of `name` to the running unit; kept where no
        profiler touched the unit."""
        if self.readings is not None:
            self._open[name] = self._open.get(name, 0.0) + seconds

    def wrap_methods(self, methods: Dict[str, Tuple[object, str]]) -> None:
        """Around every call of each `(object, method name)`: the range
        `bench::<name>` in a unit traced on host and card, and the host span
        `<name>_host_s`; by an attribute of the object that shadows the
        method, taken away by `close()`."""
        for name, (obj, attr) in methods.items():
            method = getattr(obj, attr)

            def ranged(*args, _method=method, _name=name, **kwargs):
                t = now()
                if self.phase == "ranges":
                    with torch.profiler.record_function(f"bench::{_name}"):
                        out = _method(*args, **kwargs)
                else:
                    out = _method(*args, **kwargs)
                self.add_span(f"{_name}_host_s", now() - t)
                return out

            setattr(obj, attr, ranged)
            self._restore.append(lambda obj=obj, attr=attr: delattr(obj, attr))

    def step(self) -> None:
        """Close the unit that ran."""
        if self.readings is None:
            return
        phase = self.phase
        self.readings.unit_s.setdefault(phase, []).append(now() - self._t)
        if phase == "plain":
            for name, seconds in self._open.items():
                self.readings.spans.setdefault(name, []).append(seconds)
        self._open = {}
        if self._profile is not None:
            # a finished stretch's trace is exported and parsed here, outside
            # every unit's time
            self._profile.step()
            if self._profile.done:
                self._keep(self._profile)
                self._stretch += 1
                self._profile = None
                if self._stretch == 1:
                    self._profile = Profile(1, self._units[1], host=True,
                                            device_type=self._device_type)
            self._set_active()
        self._t = now()

    def _keep(self, profile: Profile) -> None:
        if self._stretch == 0:
            self.readings.device_trace, self.readings.device_units = profile.trace, profile.units
        else:
            self.readings.range_trace, self.readings.range_units = profile.trace, profile.units

    def close(self) -> None:
        if self._profile is not None:
            self._profile.stop()
            self._profile = None
        if self.readings is not None:
            for calls in self.readings.entries.values():
                calls.active = False
        for restore in self._restore:
            restore()
        self._restore = []


def now() -> float:
    return time.perf_counter()
