"""The benchmark's data, found by name: a cell is `workloads/<cell>.json`, its
configuration `configs/<config>.json`, its traffic kind the module
`traffic/<kind>.py`, and a per-layer metric `metrics/<metric>.json`, which
names its reader, the module `readers/<reader>.py`. Adding a cell, a
configuration, a traffic mix or a metric is adding files."""

from __future__ import annotations

import glob
import importlib
import json
import os
import re
from typing import Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a name: a letter, digit or _, then at most "
                         "63 letters, digits, _, . and -")
    return name


def _load(kind: str, name: str, root: str = HERE) -> Dict:
    check_name(name, kind)
    path = os.path.join(root, f"{kind}s", f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} {name!r}: {path} does not exist")
    with open(path) as f:
        return json.load(f)


def workload(name: str, root: str = HERE) -> Dict:
    return _load("workload", name, root)


def config(name: str, root: str = HERE) -> Dict:
    return _load("config", name, root)


def metrics(root: str = HERE) -> Dict[str, Dict]:
    """Every per-layer metric file, by name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "metrics", "*.json"))):
        name = os.path.basename(path)[:-len(".json")]
        check_name(name, "metric")
        with open(path) as f:
            m = json.load(f)
        if not UNIT.match(m["unit"]):
            raise ValueError(f"metric {name}: unit {m['unit']!r}")
        out[name] = m
    return out


def metrics_for(cell: "Cell") -> Dict[str, Dict]:
    """The per-layer metrics whose file lists the cell's traffic kind."""
    return {k: m for k, m in metrics(cell.root).items()
            if cell.workload["traffic"] in m.get("kinds", ())}


def traffic_module(kind: str):
    return importlib.import_module(f"port_bench.traffic.{check_name(kind, 'traffic kind')}")


def reader_module(name: str):
    return importlib.import_module(f"port_bench.readers.{check_name(name, 'reader')}")


class Cell:
    """One run's cell: its workload and configuration files, the seed, the
    window's seconds, whether it is traced, and the clock reading at the
    process's start. `device` and `variant` are for the tests and the
    calibration: a run of the benchmark is on `cuda` with no variant."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, t0: float,
                 device: str = "cuda", variant: Optional[str] = None, root: str = HERE):
        self.name = check_name(name, "workload")
        self.root = root
        self.workload = workload(name, root)
        self.config = config(self.workload["config"], root)
        self.seed, self.seconds, self.trace, self.t0 = seed, seconds, trace, t0
        self.device, self.variant = device, variant
        self.chips = int(self.workload.get("chips", 1))
        self.params = self.workload.get("params", {})

    def program_cfg(self, extra: Sequence[str] = ()):
        """The port's config of this cell: the recipe, the configuration's
        overrides, the seed and `extra`; it has to agree with every key of the
        configuration's `cfg` block that `extra` does not set."""
        from mp_former_tpu_torch.config import build_cfg

        from .reference.config import flatten

        c = self.config
        overrides = list(c.get("overrides", [])) + ["SEED", str(self.seed)] + list(extra)
        cfg = build_cfg(os.path.join(CHECKOUT, c["recipe"]), overrides)
        have = flatten(cfg.to_dict())
        for key, want in flatten(c["cfg"]).items():
            if key in extra[::2]:
                continue
            got = have.get(key)
            if isinstance(got, tuple):
                got = list(got)
            if got != want:
                raise ValueError(f"configuration {self.workload['config']}: {key} is {got!r} "
                                 f"in the port's config and {want!r} in the file's cfg block")
        return cfg

    def reference_cfg(self):
        """The configuration's `cfg` block, with the seed, as the reference
        reads it."""
        from .reference.config import Node

        block = json.loads(json.dumps(self.config["cfg"]))
        block["SEED"] = self.seed
        return Node(block)


class Check:
    """One number compared: its value and its limit (pass: value <= limit)."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


class Outcome:
    def __init__(self, attempted: int, failed: int, metrics: Dict, device: Dict,
                 checks: List[Check], readings=None, numbers: Optional[Dict] = None):
        self.attempted, self.failed = attempted, failed
        self.metrics, self.device, self.checks = metrics, device, checks
        self.readings = readings
        # every number the check worked out, compared or not (`calibrate.py`)
        self.numbers = numbers or {}

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)
