"""Runs of the harness on the CPU at tiny sizes: the command stops where no
card is found; the rest of a run, with the card's look skipped, gives a
result that is correct; a run with the timed path broken underneath gives
`correct` false, for each fault the cells can have; and a cell, a metric and
its reader added as files are found without an edit."""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from port_bench import run, spec
from port_bench.tests.tiny import tiny_copy


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("checkout")))


def _run(root, name, variant=None, trace=False, seed=2 ** 31 + 11):
    # a traced window has to hold both profiled stretches of the tiny cells
    cell = spec.Cell(name, seed, 4.0 if trace else 1.0, trace, time.perf_counter(),
                     device="cpu", variant=variant, root=root)
    return run.run_cell(cell)


def test_command_stops_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "r50_mp_train_b16_1024", "--seed", str(2 ** 31 + 3),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_command_stops_without_the_program(capsys, monkeypatch):
    import importlib.util

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == run.PROGRAM else find_spec(name, *a))
    rc = run.main(["--workload", "swinl_serve_coco", "--seed", str(2 ** 31 + 4),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and run.PROGRAM in out.err


@pytest.mark.parametrize("name", ["tiny_train", "tiny_serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(tiny, name, trace):
    result = _run(tiny, name, trace=trace)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    if trace:
        kind = spec.workload(name, tiny)["traffic"]
        assert {k for k, m in spec.metrics(tiny).items() if kind in m["kinds"]} >= \
            set(result["metrics"])
        assert "breakdown" in result
    else:
        assert "setup_s" in result["metrics"] and "peak_gib" in result["metrics"]


@pytest.mark.parametrize("name,variant", [("tiny_train", "fault:unchanged"),
                                          ("tiny_train", "fault:half_batch"),
                                          ("tiny_serve", "fault:answer"),
                                          ("tiny_serve", "fault:mask_shift")])
def test_fault_under_the_timed_path_is_not_correct(tiny, name, variant):
    result = _run(tiny, name, variant=variant)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_added_cell_metric_and_reader_are_found_without_an_edit(tiny):
    checkout = os.path.dirname(tiny)
    with open(os.path.join(tiny, "workloads", "tiny_serve.json")) as f:
        w = json.load(f)
    w["params"]["sizes"] = [[56, 40]]
    with open(os.path.join(tiny, "workloads", "added_cell.json"), "w") as f:
        json.dump(w, f)
    with open(os.path.join(tiny, "metrics", "added_metric.serve.json"), "w") as f:
        json.dump({"reader": "added_reader", "unit": "ms", "kinds": ["serve_closed"]}, f)
    with open(os.path.join(tiny, "readers", "added_reader.py"), "w") as f:
        f.write("def read(r):\n    return None if r is None else 42.0 + r.device_units\n")
    code = textwrap.dedent("""
        import json, sys, time
        from port_bench import run, spec
        cell = spec.Cell("added_cell", 5, 4.0, True, time.perf_counter(), device="cpu")
        print(json.dumps(run.run_cell(cell)))
    """)
    env = dict(os.environ, PYTHONPATH=checkout)
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["added_metric.serve"]["value"] == 42.0 + 3  # profile_device
