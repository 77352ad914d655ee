"""The port's entry point, `python -m mp_former_tpu_torch.train_net`, against
the JAX package's `train_net.py`: the merged config of `setup` (every key but
MODEL.DEVICE, whose default is each package's device), `verify_results` on
the cases of `tests/test_eval_tasks.py::test_verify_results`; then `main` on
the CPU (`MODEL.DEVICE cpu`): 2 steps of the released training recipe at
small widths with `TPU.GRAD_ACCUM_STEPS 2` from a dataset on disk written by
`tools/make_synthetic_coco_torch.py`, and `--eval-only --resume` on it; and
what it refuses.
"""

import json
import math

import pytest
import torch

import train_net as jax_train_net
from mp_former_tpu_torch import train_net
from mp_former_tpu_torch.data.datasets.coco import register_coco_instances

from test_torch_slice import CONFIG, SMALL
from test_torch_trainer import TRAIN
from tools.make_synthetic_coco_torch import write_dataset

torch.set_num_threads(2)


def _flat(cfg, prefix=""):
    out = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _args(argv):
    return train_net.default_argument_parser().parse_args(argv)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_net_data")
    for name, split, n, size, seed in (("torch_train_net_train", "train2017", 4, 80, 0),
                                       ("torch_train_net_val", "val2017", 2, 64, 1)):
        path = write_dataset(str(root), images=n, size=size, classes=4, split=split, seed=seed)
        register_coco_instances(name, path, str(root / "coco" / split))
    return root


def test_setup_gives_the_jax_setups_merged_config(tmp_path):
    argv = ["--config-file", CONFIG, "MODEL.DN.NUM_DN", "1", "SOLVER.INSTANT_DROP", "True",
            "SOLVER.DROP_EP", "8", "SOLVER.MAX_ITER", "1200", "TPU.GRAD_ACCUM_STEPS", "2",
            "OUTPUT_DIR", str(tmp_path)]
    want = jax_train_net.setup(jax_train_net.default_argument_parser().parse_args(argv))
    got = train_net.setup(_args(argv))
    assert got.is_frozen()
    assert got.SOLVER.STEPS == want.SOLVER.STEPS == (800, 10800)  # the INSTANT_DROP hack
    w, g = _flat(want), _flat(got)
    assert set(w) == set(g) and len(w) > 150
    assert {k for k in w if w[k] != g[k]} == {"MODEL.DEVICE"}
    assert (w["MODEL.DEVICE"], g["MODEL.DEVICE"]) == ("tpu", "cuda")
    assert (tmp_path / "config.yaml").read_text() == got.dump()


def test_verify_results_agrees_with_jax():
    from mp_former_tpu.config import get_cfg as jax_get_cfg
    from mp_former_tpu_torch.config import get_cfg

    res = {"instance": {"segm": {"AP": 40.12}}}  # evaluators nest one level
    cases = [[], [["instance", "AP", 40.15, 0.2]], [["instance", "AP", 45.0, 0.2]],
             [["instance", "AR", 40.0, 1.0]], [["semantic", "mIoU", 40.0, 1.0]]]
    for expected in cases:
        outcomes = []
        for package, make_cfg in ((jax_train_net, jax_get_cfg), (train_net, get_cfg)):
            cfg = make_cfg()
            cfg.TEST.EXPECTED_RESULTS = expected
            try:
                outcomes.append(package.verify_results(cfg, res))
            except AssertionError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], expected
    assert outcomes[0] == ("result verification failed:\n  semantic/mIoU: missing from "
                           "results")


def test_main_trains_with_accumulation_then_evaluates_on_the_cpu(dataset, tmp_path):
    out = tmp_path / "out"
    opts = ["--config-file", CONFIG]
    common = [*SMALL, *TRAIN, "DATASETS.TRAIN", "('torch_train_net_train',)",
              "DATASETS.TEST", "('torch_train_net_val',)", "MODEL.DEVICE", "cpu",
              "OUTPUT_DIR", str(out)]
    assert train_net.main(_args([*opts, *common, "SOLVER.MAX_ITER", "2",
                                 "TPU.GRAD_ACCUM_STEPS", "2"])) is None
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [0, 1]
    assert all(math.isfinite(v) for x in lines for v in x.values())
    assert (out / "checkpoints" / "model_0000002.pth").is_file()
    assert "GRAD_ACCUM_STEPS: 2" in (out / "config.yaml").read_text()

    results = train_net.main(_args([*opts, "--eval-only", "--resume", "--max-eval-images", "2",
                                    *common]))
    assert set(results) == {"segm"} and math.isfinite(results["segm"]["AP"])
    # the same checkpoint named by MODEL.WEIGHTS scores the same
    again = train_net.main(_args([*opts, "--eval-only", "--max-eval-images", "2", *common,
                                  "MODEL.WEIGHTS", str(out / "checkpoints" / "model_0000002.pth")]))
    assert json.dumps(again) == json.dumps(results)  # AP of an empty area range is nan
    # with --resume the run's checkpoint wins over MODEL.WEIGHTS (d2's resume_or_load)
    resumed = train_net.main(_args([*opts, "--eval-only", "--resume", "--max-eval-images", "2",
                                    *common, "MODEL.WEIGHTS", str(tmp_path / "absent.pth")]))
    assert json.dumps(resumed) == json.dumps(results)


def test_main_refuses(tmp_path):
    """--eval-only without weights (also with --resume and no checkpoint) or
    with weights that are not on the disk, more than one card or machine, a
    CUDA device where there is none (also as `MODEL.DEVICE tpu`), and a batch
    that GRAD_ACCUM_STEPS does not divide."""
    cpu = ["MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", ""]
    cases = [(["--eval-only"], cpu, ValueError, "--eval-only needs MODEL.WEIGHTS"),
             (["--eval-only", "--resume"], cpu, ValueError, "--eval-only needs MODEL.WEIGHTS"),
             # the recipe's ImageNet .pkl, absent from the checkout
             (["--eval-only"], cpu[:2], FileNotFoundError, "R-50.pkl not found locally"),
             # NCCL takes a card a process: more processes than cards raise
             (["--num-gpus", "2"], [], ValueError, "need as many CUDA cards"),
             (["--num-machines", "2", "--dist-url", "tcp://127.0.0.1:1"], [], ValueError,
              "need as many CUDA cards") if not torch.cuda.is_available() else
             (["--num-gpus", str(torch.cuda.device_count() + 1)], [], ValueError,
              "need as many CUDA cards"),
             ([], ["SOLVER.IMS_PER_BATCH", "3", "TPU.GRAD_ACCUM_STEPS", "2", "MODEL.DEVICE",
                   "cpu"], ValueError, "divisible by TPU.GRAD_ACCUM_STEPS=2")]
    if not torch.cuda.is_available():
        cases.append(([], ["MODEL.DEVICE", "cuda"], RuntimeError, "no CUDA device"))
        # a config of the JAX package naming its accelerator asks for the card
        cases.append(([], ["MODEL.DEVICE", "tpu"], RuntimeError, "no CUDA device"))
    for flags, opts, error, match in cases:
        with pytest.raises(error, match=match):
            train_net.main(_args(["--config-file", CONFIG, *flags, *SMALL, "OUTPUT_DIR",
                                  str(tmp_path), *opts]))
