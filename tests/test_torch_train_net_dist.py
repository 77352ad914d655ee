"""The entry points launched on several ranks (`--num-gpus`, through
`parallel/dist.py:launch`), and the config's data-parallel size.

`train_net.main` with `--num-gpus 2 MODEL.DEVICE cpu` trains the released
recipe at small widths for 2 steps over gloo and scores itself, in spawned
processes where importing jax or the JAX package fails; its evaluation on 2
ranks gives every summary key that one process gives on the saved
checkpoint. `train_net_video.main` trains on 2 ranks from a
synthetic YouTube-VIS split. Tolerance: the two evaluations' keys exactly
equal.
"""

import json
import math
import os

import pytest
import torch

from mp_former_tpu_torch import train_net, train_net_video
from mp_former_tpu_torch.config import build_cfg
from mp_former_tpu_torch.parallel.dist import launch

from test_torch_slice import CONFIG, SMALL
from test_torch_trainer import TRAIN
from tools.make_synthetic_coco_torch import write_dataset

torch.set_num_threads(2)


def _no_jax(path):
    """A directory whose `jax` and `mp_former_tpu` raise on import, for the
    front of PYTHONPATH."""
    for name in ("jax", "mp_former_tpu"):
        os.makedirs(path / name, exist_ok=True)
        (path / name / "__init__.py").write_text(
            f"raise ImportError('the port imported {name}')\n")
    return str(path)


def test_train_net_trains_and_scores_on_two_ranks(tmp_path, monkeypatch, capfd):
    """Two steps and an evaluation at step 2 on 2 ranks, then the saved
    checkpoint scored by one process: the same results. The ranks are
    spawned processes whose path starts with a `jax` that raises."""
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.data.datasets.coco import register_all_coco

    root, out = tmp_path / "data", tmp_path / "out"
    write_dataset(str(root), images=4, size=80, classes=4, split="train2017", seed=0)
    write_dataset(str(root), images=3, size=64, classes=4, split="val2017", seed=1)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(root))
    monkeypatch.syspath_prepend(_no_jax(tmp_path / "nojax"))
    for name in ("coco_2017_train", "coco_2017_val"):
        monkeypatch.delitem(DatasetCatalog._registry, name, raising=False)
    register_all_coco(str(root))
    common = ["--config-file", CONFIG, *SMALL, *TRAIN, "DATASETS.TRAIN", "('coco_2017_train',)",
              "DATASETS.TEST", "('coco_2017_val',)", "MODEL.DEVICE", "cpu",
              "MODEL.MASK_FORMER.DEC_LAYERS", "2", "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS",
              "1", "DATALOADER.NUM_WORKERS", "1", "OUTPUT_DIR", str(out)]
    capfd.readouterr()
    assert train_net.main(train_net.default_argument_parser().parse_args(
        ["--num-gpus", "2", *common, "SOLVER.MAX_ITER", "2", "TEST.EVAL_PERIOD", "2"])) is None
    logs = capfd.readouterr().err
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [0, 1]  # rank 0 alone writes
    assert all(math.isfinite(v) for x in lines for v in x.values())
    assert sorted(os.listdir(out / "checkpoints")) == ["last_checkpoint", "model_0000002.pth"]
    # both ranks log the merged results of the evaluation at step 2
    logged = [eval(x.split("eval results: ", 1)[1], {"nan": math.nan})
              for x in logs.splitlines() if "eval results: " in x]
    assert len(logged) == 2 and json.dumps(logged[0]) == json.dumps(logged[1]), logs[-3000:]
    one = train_net.main(train_net.default_argument_parser().parse_args(
        ["--eval-only", "--resume", *common]))
    assert set(one) == {"segm"} and math.isfinite(one["segm"]["AP"])
    assert json.dumps(logged[0]) == json.dumps(one)


def test_train_net_video_trains_on_two_ranks(tmp_path, monkeypatch):
    """Clips on two ranks through the clip loader's rank blocks, whose slot
    axes the step pads to the largest rank's."""
    from test_torch_video import SMALL as VIDEO_SMALL
    from tools.make_synthetic_ytvis_torch import write_dataset as write_ytvis

    write_ytvis(str(tmp_path), videos=4, frames=(3,), height=64, width=64, classes=40,
                split="train", seed=0)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(tmp_path))
    out = tmp_path / "out"
    args = train_net_video.default_argument_parser().parse_args([
        "--num-gpus", "2", "--config-file",
        "configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml", *VIDEO_SMALL,
        "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.MASK_FORMER.DEC_LAYERS", "2",
        "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1", "INPUT.MIN_SIZE_TRAIN", "(48, 64)",
        "INPUT.MAX_SIZE_TRAIN", "96", "SOLVER.IMS_PER_BATCH", "4", "SOLVER.MAX_ITER", "1",
        "DATALOADER.NUM_WORKERS", "1", "OUTPUT_DIR", str(out)])
    assert train_net_video.main(args) is None
    line = json.loads((out / "metrics.json").read_text())
    assert line["iteration"] == 0 and math.isfinite(line["total_loss"])
    assert (out / "checkpoints" / "model_0000001.pth").is_file()


def test_data_parallel_size_rules():
    """`TPU.MESH_SHAPE` [-1] is every rank, [W] must be the world size, and
    the one axis must be `data`."""
    from mp_former_tpu_torch.parallel.mesh import data_parallel_size

    def cfg(shape, axes=("data",)):
        return build_cfg("", ["TPU.MESH_SHAPE", str(list(shape)),
                              "TPU.MESH_AXES", str(list(axes))])

    assert data_parallel_size(cfg([-1]), 4) == 4
    assert data_parallel_size(cfg([2]), 2) == 2
    with pytest.raises(ValueError, match="asks for 8 data-parallel ranks, but 2"):
        data_parallel_size(cfg([8]), 2)
    with pytest.raises(ValueError, match=r"one axis, \['data'\]"):
        data_parallel_size(cfg([2], ("model",)), 2)
    with pytest.raises(ValueError, match=r"one axis, \['data'\]"):
        data_parallel_size(cfg([2, 2], ("data", "model")), 4)


def test_more_processes_than_cards_raise(tmp_path):
    """`--num-gpus` above the visible cards raises before any process
    starts (NCCL takes a card a process); there is no CPU fallback."""
    n = max(2, torch.cuda.device_count() + 1)
    for entry in (train_net, train_net_video):
        args = entry.default_argument_parser().parse_args(
            ["--num-gpus", str(n), "OUTPUT_DIR", str(tmp_path)])
        with pytest.raises(ValueError, match=f"{n} processes a machine over NCCL need as "
                                             "many CUDA cards"):
            entry.main(args)
    with pytest.raises(ValueError, match="need as many CUDA cards"):
        launch(print, n, backend="nccl")
