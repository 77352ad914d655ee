"""Every ResNet recipe directly under configs/{ade20k,cityscapes,
mapillary-vistas}/*/ starts in the port: its DATASETS.TRAIN records,
INPUT.DATASET_MAPPER_NAME's mapper on one of them at the recipe's own input
settings (one static canvas: the crop rounded up to 32), and
`build_evaluator` for DATASETS.TEST. Then one recipe of each mapper kind
trains a step and scores itself through `train_net.main` on the CPU at a
small size (`MODEL.DEVICE cpu`, narrow widths, the recipe's own class count
and decoder), with `--eval-only --resume`. The datasets are written by
`tools/make_synthetic_segm_torch.py` as `.npy` files.
"""

import glob
import math
import os
from unittest import mock

import numpy as np
import pytest
import torch

from mp_former_tpu_torch import train_net
from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.data import dataset_mappers  # noqa: F401  (registration)
from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.data.datasets import builtin  # noqa: F401  (registered before the mocks)
from mp_former_tpu_torch.data.datasets.register_all import register_all, register_more
from mp_former_tpu_torch.evaluation.build import build_evaluator
from mp_former_tpu_torch.utils.registry import DATASET_MAPPER_REGISTRY

from test_torch_slice import SMALL
from tools.make_synthetic_segm_torch import write_dataset

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..", "configs")
RECIPES = sorted(os.path.relpath(p, ROOT) for d in ("ade20k", "cityscapes", "mapillary-vistas")
                 for p in glob.glob(os.path.join(ROOT, d, "*", "*.yaml"))
                 if not os.path.basename(p).startswith("Base-"))
# the recipes' own decoder (the vanilla one) at SMALL's widths
VANILLA = [v if v != "MultiScaleMaskedTransformerDecoderMaskDN"
           else "MultiScaleMaskedTransformerDecoder" for v in SMALL]
TINY_INPUT = ["INPUT.MIN_SIZE_TRAIN", "(64, 80)", "INPUT.MAX_SIZE_TRAIN", "160",
              "INPUT.CROP.SIZE", "(64, 64)", "INPUT.MIN_SIZE_TEST", "64",
              "INPUT.MAX_SIZE_TEST", "128", "SOLVER.IMS_PER_BATCH", "2",
              "DATALOADER.NUM_WORKERS", "1", "TPU.MAX_INSTANCES", "20",
              "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256", "MODEL.WEIGHTS", "",
              "MODEL.DEVICE", "cpu", "SEED", "0"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_segm_recipes"))
    for seed, split in enumerate(("train", "val")):
        write_dataset(root, "ade20k", split, 2, 96, 128, seed)
        write_dataset(root, "cityscapes", split, 2, 128, 256, seed)
        write_dataset(root, "mapillary", split, 2, 96, 128, seed)
    return root


@pytest.fixture
def catalogs(root):
    """The builtin names registered from the synthetic tree only (and
    restored afterwards)."""
    with mock.patch.object(DatasetCatalog, "_registry", {}), \
            mock.patch.object(MetadataCatalog, "_meta", {}):
        register_all(root)
        register_more(root)
        yield


def _cfg(rel, overrides=()):
    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(os.path.join(ROOT, rel))
    cfg.merge_from_list(list(overrides))
    return cfg


def test_the_recipes_are_the_21_resnet_ones():
    assert len(RECIPES) == 21 and not any("swin" in r for r in RECIPES)


@pytest.mark.parametrize("rel", RECIPES)
def test_recipe_builds_its_mapper_and_evaluators(catalogs, rel):
    cfg = _cfg(rel)
    assert cfg.MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME == "MultiScaleMaskedTransformerDecoder"
    records = DatasetCatalog.get(cfg.DATASETS.TRAIN[0])
    assert records
    mapper = DATASET_MAPPER_REGISTRY.get(cfg.INPUT.DATASET_MAPPER_NAME)(
        cfg, is_train=True, max_instances=cfg.TPU.MAX_INSTANCES)
    ch, cw = cfg.INPUT.CROP.SIZE
    samples = [mapper(records[0], np.random.RandomState(seed)) for seed in range(3)]
    for sample in samples:
        assert sample["image"].shape == ((ch + 31) // 32 * 32, (cw + 31) // 32 * 32, 3)
        assert (sample["labels"] < cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES).all()
    # a crop may miss every object; the loader drops such a sample
    assert any(sample["valid"].any() for sample in samples)
    evset = build_evaluator(cfg, cfg.DATASETS.TEST[0])
    assert evset.tasks


TRAINED = [
    ("ade20k/semantic-segmentation/maskformer2_R50_bs16_160k.yaml", {"sem_seg": "mIoU"}),
    ("cityscapes/instance-segmentation/maskformer2_R50_bs16_90k.yaml", {"segm": "AP"}),
    # its DATASETS.TEST has no semantic ground truth (as the JAX package
    # registers it) and INSTANCE_ON is off: PQ alone
    ("mapillary-vistas/panoptic-segmentation/maskformer_R50_bs16_300k.yaml",
     {"panoptic_seg": "All"}),
]


# the cases keep the ids they were given when the Mapillary one scored a
# split of its own with semantic ground truth
@pytest.mark.parametrize("rel,keys", TRAINED, ids=[
    f"{TRAINED[0][0]}-keys0-None", f"{TRAINED[1][0]}-keys1-None",
    f"{TRAINED[2][0]}-keys2-mapillary_vistas_panoptic_val_with_sem_seg"])
def test_recipe_trains_a_step_and_scores_itself(catalogs, tmp_path, rel, keys):
    opts = ["--config-file", os.path.join(ROOT, rel)]
    # the canvas of a 64-pixel crop (ADE20K's SIZE_DIVISIBILITY 512 and
    # Mapillary's 1024 would pad it to 512 and 1024; the canvases at the
    # recipes' own sizes are test_recipe_builds_its_mapper_and_evaluators')
    overrides = [*VANILLA, *TINY_INPUT, "INPUT.SIZE_DIVISIBILITY", "32", "SOLVER.MAX_ITER", "1",
                 "OUTPUT_DIR", str(tmp_path)]
    parse = train_net.default_argument_parser().parse_args
    torch.manual_seed(0)
    train_net.main(parse([*opts, *overrides]))
    assert os.path.isfile(tmp_path / "checkpoints" / "model_0000001.pth")
    results = train_net.main(parse([*opts, "--eval-only", "--resume", "--max-eval-images", "2",
                                    *overrides]))
    assert set(results) == set(keys)
    for task, key in keys.items():
        value = results[task][key]["PQ"] if task == "panoptic_seg" else results[task][key]
        assert math.isfinite(value), (task, results[task])
