"""Every image Swin recipe (`configs/{coco,ade20k,cityscapes,
mapillary-vistas}/*/swin/*.yaml`, 41 of them) starts in the port: its config
loads, its `D2SwinTransformer` builds on the meta device with the recipe's own
MODEL.SWIN shapes, INPUT.DATASET_MAPPER_NAME's mapper maps one of its
DATASETS.TRAIN records at the recipe's own input settings, and
`build_evaluator` builds for DATASETS.TEST (as tests/test_torch_segm_recipes.py
does for the ResNet ones). Then one Swin recipe of each task (instance,
panoptic, semantic) trains a step and scores itself through `train_net.main`
on the CPU at tiny widths (`MODEL.DEVICE cpu`), with `--eval-only --resume`.
The datasets are written by `tools/make_synthetic_coco_torch.py` and
`tools/make_synthetic_segm_torch.py`.
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
from mp_former_tpu_torch.data.datasets.coco import register_all_coco
from mp_former_tpu_torch.data.datasets.register_all import (register_all,
                                                            register_all_coco_panoptic,
                                                            register_more)
from mp_former_tpu_torch.evaluation.build import build_evaluator
from mp_former_tpu_torch.models.backbone.swin import build_swin_backbone
from mp_former_tpu_torch.utils.registry import DATASET_MAPPER_REGISTRY

from test_torch_segm_recipes import TINY_INPUT, VANILLA
from tools.make_synthetic_coco_torch import write_dataset as write_coco
from tools.make_synthetic_segm_torch import write_dataset as write_segm

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..", "configs")
RECIPES = sorted(os.path.relpath(p, ROOT) for d in ("coco", "ade20k", "cityscapes",
                                                    "mapillary-vistas")
                 for p in glob.glob(os.path.join(ROOT, d, "*", "swin", "*.yaml")))
TINY_SWIN = ["MODEL.SWIN.EMBED_DIM", "16", "MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]",
             "MODEL.SWIN.NUM_HEADS", "[2, 4, 4, 8]", "MODEL.SWIN.WINDOW_SIZE", "4"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_swin_recipes"))
    for seed, (split, n) in enumerate((("train", 2), ("val", 2))):
        write_coco(root, images=n, size=96, classes=4, split=f"{split}2017", seed=seed,
                   panoptic=True)
        write_segm(root, "ade20k", split, n, 96, 128, seed)
        write_segm(root, "cityscapes", split, n, 128, 256, seed)
        write_segm(root, "mapillary", split, n, 96, 128, seed)
    return root


@pytest.fixture
def catalogs(root):
    """The builtin names registered from the synthetic tree only (and
    restored afterwards)."""
    with mock.patch.object(DatasetCatalog, "_registry", {}), \
            mock.patch.object(MetadataCatalog, "_meta", {}):
        register_all_coco(root)
        register_all_coco_panoptic(root)
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


def test_the_swin_recipes_are_the_41_image_ones():
    assert len(RECIPES) == 41
    assert {r.split(os.sep)[0] for r in RECIPES} == {"coco", "ade20k", "cityscapes",
                                                     "mapillary-vistas"}


@pytest.mark.parametrize("rel", RECIPES)
def test_swin_recipe_builds_its_backbone_mapper_and_evaluators(catalogs, rel):
    cfg = _cfg(rel)
    s = cfg.MODEL.SWIN
    assert cfg.MODEL.BACKBONE.NAME == "D2SwinTransformer"
    with torch.device("meta"):
        backbone = build_swin_backbone(cfg)
    assert [len(layer.blocks) for layer in backbone.layers] == list(s.DEPTHS)
    assert [layer.blocks[0].attn.num_heads for layer in backbone.layers] == list(s.NUM_HEADS)
    assert backbone.layers[0].blocks[1].shift_size == s.WINDOW_SIZE // 2
    assert {k: (v.channels, v.stride) for k, v in backbone.output_shape().items()} == {
        f"res{i + 2}": (s.EMBED_DIM * 2 ** i, 2 ** (i + 2)) for i in range(4)}
    records = DatasetCatalog.get(cfg.DATASETS.TRAIN[0])
    assert records
    mapper = DATASET_MAPPER_REGISTRY.get(cfg.INPUT.DATASET_MAPPER_NAME)(
        cfg, is_train=True, max_instances=cfg.TPU.MAX_INSTANCES)
    if cfg.INPUT.DATASET_MAPPER_NAME.startswith("coco_"):
        canvas = (cfg.INPUT.IMAGE_SIZE, cfg.INPUT.IMAGE_SIZE)
    else:
        canvas = tuple((n + 31) // 32 * 32 for n in cfg.INPUT.CROP.SIZE)
    samples = [mapper(records[0], np.random.RandomState(seed)) for seed in range(3)]
    for sample in samples:
        assert sample["image"].shape == (*canvas, 3)
        assert (sample["labels"] < cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES).all()
    # a crop may miss every object; the loader drops such a sample
    assert any(sample["valid"].any() for sample in samples)
    assert build_evaluator(cfg, cfg.DATASETS.TEST[0]).tasks


TRAINED = [
    ("coco/instance-segmentation/swin/maskformer2_swin_large_IN21k_384_bs16_100ep.yaml",
     {"segm": "AP"}),
    ("coco/panoptic-segmentation/swin/maskformer2_swin_base_384_bs16_50ep.yaml",
     {"panoptic_seg": "All", "sem_seg": "mIoU", "segm": "AP"}),
    ("ade20k/semantic-segmentation/swin/maskformer2_swin_tiny_bs16_160k.yaml",
     {"sem_seg": "mIoU"}),
]


@pytest.mark.parametrize("rel,keys", TRAINED, ids=[t[0].split(os.sep)[1] for t in TRAINED])
def test_swin_recipe_trains_a_step_and_scores_itself(catalogs, tmp_path, rel, keys):
    opts = ["--config-file", os.path.join(ROOT, rel)]
    overrides = [*VANILLA, *TINY_SWIN, *TINY_INPUT, "INPUT.IMAGE_SIZE", "64",
                 "INPUT.SIZE_DIVISIBILITY", "32", "SOLVER.MAX_ITER", "1",
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
