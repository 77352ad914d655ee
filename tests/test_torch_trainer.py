"""The port's `Trainer` fed from a COCO-format dataset on disk: no loader
passed, so it builds `build_train_loader(cfg)` (LSJ mapper, worker threads),
trains a few steps of a small model on the CPU, evaluates every
TEST.EVAL_PERIOD steps through `Trainer.test` -> `run_evaluation`, writes
`metrics.json` with `data_time`, calls hooks, keeps the last 3 checkpoints and
closes the loader. The dataset is written by `tools/make_synthetic_coco_torch.py`.
"""

import contextlib
import json
import logging
import math

import numpy as np
import pytest
import torch

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.data.datasets.coco import register_coco_instances
from mp_former_tpu_torch.engine import trainer as trainer_mod
from mp_former_tpu_torch.engine.trainer import Trainer
from mp_former_tpu_torch.models import build_model

from test_torch_slice import CONFIG, SMALL
from tools.make_synthetic_coco_torch import write_dataset

torch.set_num_threads(2)

# the released training recipe (chip_smoke.py's TRAIN_OVERRIDES) on SMALL widths
TRAIN = ["MODEL.MASK_FORMER.DN_MODE", "points", "MODEL.DN.NUM_DN", "1",
         "MODEL.DN.NOISE_SCALE", "0.0", "MODEL.MASK_FORMER.ALL_LY_DN", "True",
         "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.2", "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256",
         "MODEL.SEM_SEG_HEAD.NUM_CLASSES", "4", "MODEL.WEIGHTS", "",
         "INPUT.IMAGE_SIZE", "64", "SOLVER.IMS_PER_BATCH", "2", "TPU.MAX_INSTANCES", "10",
         "DATALOADER.NUM_WORKERS", "2", "DATASETS.TRAIN", "('torch_trainer_train',)",
         "DATASETS.TEST", "('torch_trainer_val',)"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trainer_data")
    for name, split, n, size, seed in (("torch_trainer_train", "train2017", 6, 80, 0),
                                       ("torch_trainer_val", "val2017", 3, 64, 1)):
        path = write_dataset(str(root), images=n, size=size, classes=4, split=split, seed=seed)
        register_coco_instances(name, path, str(root / "coco" / split))
    return root


def _cfg(out_dir, overrides=()):
    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list([*SMALL, *TRAIN, "OUTPUT_DIR", str(out_dir), *overrides])
    return cfg


def _seeded_model(cfg):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build_model(cfg)


def test_trainer_trains_and_tests_from_a_dataset_on_disk(dataset, tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, ["SOLVER.MAX_ITER", "4", "SOLVER.CHECKPOINT_PERIOD", "1",
                          "TEST.EVAL_PERIOD", "2"])
    cfg.TEST.MAX_EVAL_IMAGES = 2  # read as the JAX trainer reads it: TEST.get
    loaders = []

    def spy_build(*args, **kwargs):
        loaders.append(build(*args, **kwargs))
        return loaders[-1]

    build = trainer_mod.build_train_loader
    monkeypatch.setattr(trainer_mod, "build_train_loader", spy_build)
    trainer = Trainer(cfg, model=_seeded_model(cfg), device="cpu")
    trainer.model.train()
    results, evaluated = [], []
    test = trainer.test

    def spy_test(max_images=None):
        evaluated.append(max_images)
        results.append(test(max_images))
        return results[-1]

    trainer.test = spy_test
    seen = []
    trainer.train(hooks={"record": lambda step, t: seen.append((step, t.model.training))})

    assert seen == [(s, True) for s in range(4)]  # test() keeps the train mode
    assert trainer.iteration == 4 and evaluated == [2, 2]
    for r in results:
        assert set(r) == {"segm"} and math.isfinite(r["segm"]["AP"])
    lines = [json.loads(x) for x in (tmp_path / "metrics.json").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [0, 3]
    for x in lines:
        assert x["data_time"] >= 0 and all(math.isfinite(v) for v in x.values())
        assert {"total_loss", "loss_ce", "loss_mask_dn_2", "loss_dice_1"} <= set(x)
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "last_checkpoint", "model_0000002.pth", "model_0000003.pth", "model_0000004.pth"]
    assert len(loaders) == 1 and not loaders[0]._thread.is_alive()
    assert trainer.resume_or_load() == 4


def test_trainer_closes_its_loader_when_a_step_raises(dataset, tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, ["SOLVER.MAX_ITER", "3"])
    loaders = []
    build = trainer_mod.build_train_loader
    monkeypatch.setattr(trainer_mod, "build_train_loader",
                        lambda *a, **k: loaders.append(build(*a, **k)) or loaders[-1])
    trainer = Trainer(cfg, model=_seeded_model(cfg), device="cpu")

    def fail(step, t):
        raise KeyError("hook")

    with pytest.raises(KeyError, match="hook"):
        trainer.train(hooks={"fail": fail})
    assert trainer.iteration == 1 and not loaders[0]._thread.is_alive()


def test_test_skips_datasets_the_port_cannot_evaluate(dataset, tmp_path, caplog):
    MetadataCatalog.get("torch_trainer_semseg").set(evaluator_type="sem_seg")
    if "torch_trainer_semseg" not in DatasetCatalog:
        DatasetCatalog.register("torch_trainer_semseg", lambda: [])
    cfg = _cfg(tmp_path, ["DATASETS.TEST", "('torch_trainer_semseg', 'not_registered')"])
    trainer = Trainer(cfg, train_loader=iter(()), model=_seeded_model(cfg), device="cpu")
    trainer.model.eval()
    with caplog.at_level(logging.WARNING):
        assert trainer.test() is None
    assert "ROADMAP A16" in caplog.text and "not_registered not registered" in caplog.text
    assert not trainer.model.training
    # two datasets: results keyed by name
    cfg2 = _cfg(tmp_path, ["DATASETS.TEST", "('torch_trainer_val', 'torch_trainer_semseg')"])
    trainer.cfg = cfg2
    res = trainer.test(max_images=1)
    assert set(res) == {"torch_trainer_val"} and np.isfinite(res["torch_trainer_val"]["segm"]["AP"])


def test_run_step_wraps_each_stage(tmp_path):
    """`Trainer.run_step(batch, stage=...)` enters `stage(name)` around each
    stage of `engine/train_step.py:train_step`, micro-batch by micro-batch,
    and computes what the step computes without it; by default the stages
    are `record_function` ranges that a profiler trace of the step shows."""
    from torch.profiler import ProfilerActivity, profile

    from mp_former_tpu_torch.data.synthetic import synthetic_batches

    cfg = _cfg(tmp_path, ["TPU.GRAD_ACCUM_STEPS", "2"])
    batch = next(synthetic_batches(2, 64, 4, 5, seed=0))
    seen = []

    @contextlib.contextmanager
    def stage(name):
        seen.append(name)
        yield

    got = Trainer(cfg, iter(()), model=_seeded_model(cfg), device="cpu").run_step(batch, stage)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        want = Trainer(cfg, iter(()), model=_seeded_model(cfg), device="cpu").run_step(batch)
    micro = ["forward", "matcher_costs", "matcher_host", "losses", "backward"]
    assert seen == micro * 2 + ["optimizer"]
    assert {f"stage::{s}" for s in seen} <= {e.key for e in prof.key_averages()}
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
