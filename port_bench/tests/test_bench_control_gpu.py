"""The control on the card, at each cell's own size: the program in
`TPU.COMPUTE_DTYPE bfloat16`, the precision below the configurations'
float32, has to come out not correct against the limits, on three seeds.
Needs a CUDA card (marker `gpu`; run on the card with
`python -m pytest port_bench/tests -m gpu`); about 6 minutes."""

import json
import time

import pytest

from port_bench import run, spec

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    run.set_cache_dirs(run.ROOT)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["r50_mp_train_b16_1024", "swinl_serve_coco"])
def test_control_is_not_correct(card, name):
    for seed in SEEDS:
        cell = spec.Cell(name, seed, 4.0, False, time.perf_counter(), variant="control")
        result = run.run_cell(cell)
        print(json.dumps({"cell": name, "seed": seed, "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
        assert result["correct"] is False, (seed, result["checks"])
