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
    # LVIS is the one evaluator type the port does not evaluate yet (ROADMAP A16c)
    MetadataCatalog.get("torch_trainer_lvis").set(evaluator_type="lvis")
    if "torch_trainer_lvis" not in DatasetCatalog:
        DatasetCatalog.register("torch_trainer_lvis", lambda: [])
    cfg = _cfg(tmp_path, ["DATASETS.TEST", "('torch_trainer_lvis', 'not_registered')"])
    trainer = Trainer(cfg, train_loader=iter(()), model=_seeded_model(cfg), device="cpu")
    trainer.model.eval()
    with caplog.at_level(logging.WARNING):
        assert trainer.test() is None
    assert "ROADMAP A16" in caplog.text and "not_registered not registered" in caplog.text
    assert not trainer.model.training
    # two datasets: results keyed by name
    cfg2 = _cfg(tmp_path, ["DATASETS.TEST", "('torch_trainer_val', 'torch_trainer_lvis')"])
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


def test_profile_dir_traces_steps_five_to_seven(tmp_path):
    """TPU.PROFILE_DIR (the JAX trainer's trace window, steps start+5 to
    start+7): set, nine steps leave one Chrome trace of those steps in the
    directory; empty, nothing is recorded."""
    from mp_former_tpu_torch.data.synthetic import synthetic_batches

    traces = tmp_path / "profile"
    for profile_dir in (str(traces), ""):
        cfg = _cfg(tmp_path / "out", ["SOLVER.MAX_ITER", "9", "TPU.PROFILE_DIR", profile_dir])
        trainer = Trainer(cfg, synthetic_batches(2, 64, 4, 5, seed=0), model=_seeded_model(cfg),
                          device="cpu")
        started = []
        start = trainer._start_profile
        trainer._start_profile = lambda: started.append(trainer.iteration) or start()
        trainer.train()
        assert trainer.iteration == 9 and started == ([5] if profile_dir else [])
    assert [p.name for p in traces.iterdir()] == ["steps_5-7.pt.trace.json"]
    trace = json.loads((traces / "steps_5-7.pt.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "stage::forward" in names and "stage::optimizer" in names


def test_trainer_trains_and_tests_the_panoptic_recipe(tmp_path):
    """The panoptic launcher's recipe on SMALL widths from a tiny dataset of
    `tools/make_synthetic_coco_torch.py --panoptic`, registered as
    `register_all_coco_panoptic` registers the `_with_sem_seg` splits: 2
    steps through the `coco_panoptic_lsj` mapper, then `Trainer.test` on the
    val split scores PQ, mIoU and AP (the three TEST switches of the YAML)."""
    from mp_former_tpu_torch.data.datasets.register_all import register_coco_panoptic

    root = tmp_path / "data"
    names = {}
    for split, n, size, seed in (("train2017", 4, 80, 0), ("val2017", 2, 64, 1)):
        write_dataset(str(root), images=n, size=size, classes=4, split=split, seed=seed,
                      panoptic=True)
        names[split] = f"torch_trainer_panoptic_{split}_{tmp_path.name}"
        coco = root / "coco"
        register_coco_panoptic(names[split], str(coco / f"annotations/panoptic_{split}.json"),
                               str(coco / split), str(coco / f"panoptic_{split}"),
                               semseg_root=str(coco / f"panoptic_semseg_{split}"),
                               instances_json=str(coco / f"annotations/instances_{split}.json"),
                               ignore_label=255)
    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file("configs/coco/panoptic-segmentation/maskformer2_R50_bs16_50ep.yaml")
    cfg.merge_from_list([*SMALL, *TRAIN[:-4], "MODEL.SEM_SEG_HEAD.NUM_CLASSES", "5",
                         "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", str(tmp_path / "out"),
                         "DATASETS.TRAIN", f"('{names['train2017']}',)",
                         "DATASETS.TEST", f"('{names['val2017']}',)"])
    assert cfg.INPUT.DATASET_MAPPER_NAME == "coco_panoptic_lsj"
    trainer = Trainer(cfg, model=_seeded_model(cfg), device="cpu")
    trainer.train()
    assert trainer.iteration == 2
    lines = [json.loads(x) for x in (tmp_path / "out" / "metrics.json").read_text().splitlines()]
    assert all(math.isfinite(v) for x in lines for v in x.values())
    res = trainer.test()
    assert set(res) == {"panoptic_seg", "sem_seg", "segm"}
    assert math.isfinite(res["panoptic_seg"]["All"]["PQ"]) and math.isfinite(res["sem_seg"]["mIoU"])
    assert math.isfinite(res["segm"]["AP"])
