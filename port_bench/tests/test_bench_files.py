"""The benchmark's data files: each loads, its names and units use only the
allowed characters, and BENCHMARK.json names only what the files hold."""

import json
import os

import pytest

from port_bench import spec
from port_bench.tests.tiny import BENCH

ROOT = os.path.dirname(BENCH)
WORKLOADS = sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "workloads")))
CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "configs")))


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_loads(name):
    w = spec.workload(name)
    spec.check_name(w["config"], "config")
    spec.check_name(w["traffic"], "traffic")
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert spec.config(w["config"])["name"] == w["config"]
    assert set(w["limits"]) and all(v >= 0 for v in w["limits"].values())
    spec.traffic_module(w["traffic"])


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads(name):
    c = spec.config(name)
    assert c["name"] == name
    assert 1 <= len(c["source"]) <= 200
    assert len(c["reduced"]) <= 16
    for key in c["reduced"]:
        spec.check_name(key, "reduced key")
    assert os.path.isfile(os.path.join(ROOT, c["recipe"]))


def test_metric_files_load():
    ms = spec.metrics()
    assert ms
    for name, m in ms.items():
        spec.check_name(name, "metric")
        assert spec.UNIT.match(m["unit"])
        spec.reader_module(m["reader"])
        assert m["kinds"]


def test_benchmark_json_names_only_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert {c["name"] for c in b["configs"]} <= set(CONFIGS)
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert spec.config(c["name"])["source"] == c["source"]
    for w in b["workloads"]:
        spec.check_name(w["name"], "workload")
        f = spec.workload(w["name"])
        assert (f["config"], f["traffic"], f["chips"], f["why"]) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
    files = spec.metrics()
    for m in b["per_layer"]:
        assert m["name"] in files and files[m["name"]]["unit"] == m["unit"]
        kinds = {spec.workload(w)["traffic"] for w in m["workloads"]}
        assert kinds <= set(files[m["name"]]["kinds"])
    for m in b["end_to_end"] + b["per_layer"]:
        spec.check_name(m["name"], "metric")
        assert spec.UNIT.match(m["unit"])
