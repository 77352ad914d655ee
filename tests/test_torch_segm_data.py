"""The port's data layer of the ADE20K, Cityscapes and Mapillary Vistas
recipes against the JAX package: ResizeShortestEdge and ColorAugSSD on the
same `RandomState`, the three MaskFormer mappers (`mask_former_semantic`,
`_panoptic`, `_instance`) on the same records and seeds, and `register_all` /
`register_more` on a synthetic tree of each dataset written by
`tools/make_synthetic_segm_torch.py`.

The port reads the tool's `.npy` files; the JAX package reads PNG (and JPEG)
files written here from the same arrays with cv2. Mapper labels, masks, valid
flags and crop records must be equal; the image within one grey level (cv2
resizes uint8 in fixed point, the port rounds a float32 `F.interpolate`).
"""

import os
from unittest import mock

import cv2
import numpy as np
import pytest
import torch

from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.data import transforms as jax_transforms
from mp_former_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from mp_former_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from mp_former_tpu.data.dataset_mappers import mask_former_mappers as jax_mappers
from mp_former_tpu.data.datasets import register_all as jax_register

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.data import transforms
from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.data.dataset_mappers import mask_former_mappers as mappers
from mp_former_tpu_torch.data.datasets import register_all as port_register
from mp_former_tpu_torch.data.datasets.register_all import npy_twin

from tools.make_synthetic_segm_torch import write_dataset

torch.set_num_threads(2)

GREY_LEVELS = 1
CITYSCAPES = {kind: f"configs/cityscapes/{kind}-segmentation/maskformer2_R50_bs16_90k.yaml"
              for kind in ("semantic", "instance", "panoptic")}
MAPPER = {"semantic": "MaskFormerSemanticDatasetMapper",
          "panoptic": "MaskFormerPanopticDatasetMapper",
          "instance": "MaskFormerInstanceDatasetMapper"}
# the recipes' pipeline at a test's size: multi-scale short sides, a crop with
# the category-area limit below 1 (its retry loop runs), colour augmentation
SMALL_INPUT = ["INPUT.MIN_SIZE_TRAIN", "(64, 80, 96, 128)", "INPUT.MAX_SIZE_TRAIN", "256",
               "INPUT.CROP.SIZE", "(48, 96)", "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", "0.75",
               "INPUT.COLOR_AUG_SSD", "True", "TPU.GT_MASK_STRIDE", "4"]


def _cfgs(config, overrides):
    out = []
    for get, deeplab, mf2 in ((jax_get_cfg, jax_add_deeplab, jax_add_mf2),
                              (get_cfg, add_deeplab_config, add_maskformer2_config)):
        cfg = get()
        deeplab(cfg)
        mf2(cfg)
        cfg.merge_from_file(config)
        cfg.merge_from_list(overrides)
        out.append(cfg)
    return out


def _id2rgb(ids):
    return np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)


def write_png_twins(root):
    """Beside each `.npy` the file the JAX package decodes: images as PNG
    (Cityscapes) or JPEG (the others' `.jpg` names), panoptic id maps as the
    RGB encoding, Cityscapes instanceIds as 16-bit PNG, other maps as 8-bit."""
    for cur, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".npy"):
                continue
            path = os.path.join(cur, f)
            a = np.load(path)
            if a.ndim == 3:
                ext = ".png" if f.endswith("_leftImg8bit.npy") else ".jpg"
                cv2.imwrite(path[:-4] + ext, a)
            elif a.dtype == np.uint32:
                cv2.imwrite(path[:-4] + ".png", _id2rgb(a)[..., ::-1])
            elif a.dtype == np.int32:
                cv2.imwrite(path[:-4] + ".png", a.astype(np.uint16))
            else:
                cv2.imwrite(path[:-4] + ".png", a)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same seeded datasets twice: `.npy` only, and with PNG/JPEG twins."""
    roots = {}
    for form in ("npy", "png"):
        root = str(tmp_path_factory.mktemp(f"torch_segm_{form}"))
        for seed, split in enumerate(("train", "val")):
            write_dataset(root, "ade20k", split, 2, 64, 96, seed)
            write_dataset(root, "cityscapes", split, 3, 96, 192, seed)
            write_dataset(root, "mapillary", split, 2, 72, 96, seed)
        if form == "png":
            write_png_twins(root)
        roots[form] = root
    return roots


def test_resize_shortest_edge_and_color_aug_draw_as_jax():
    rng_img = np.random.RandomState(0)
    for seed in range(12):
        for style, sizes in (("choice", (64, 80, 96)), ("range", (64, 128))):
            for h, w in ((96, 192), (200, 120)):
                a = transforms.resize_shortest_edge(np.random.RandomState(seed), h, w, sizes, 150,
                                                    style, flip=True)
                b = jax_transforms.resize_shortest_edge(np.random.RandomState(seed), h, w, sizes,
                                                        150, style, flip=True)
                assert vars(a) == vars(b)
        img = rng_img.randint(0, 256, (17, 23, 3)).astype(np.uint8)
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(transforms.color_aug_ssd(r1, img),
                                      jax_transforms.color_aug_ssd(r2, img))
        assert r1.randint(1 << 30) == r2.randint(1 << 30)  # the same draws consumed
    assert vars(transforms.resize_shortest_edge(None, 50, 100, (64,), 100)) == \
        vars(jax_transforms.resize_shortest_edge(None, 50, 100, (64,), 100))


def _port_record(record):
    """The record with each file through its `.npy` twin (what the port
    reads on the machine without an image decoder)."""
    out = dict(record)
    for k in ("file_name", "sem_seg_file_name", "pan_seg_file_name"):
        if k in out:
            out[k] = npy_twin(out[k])
    return out


@pytest.mark.parametrize("kind,crop", [("semantic", "absolute"), ("panoptic", "absolute"),
                                       ("instance", "absolute"), ("semantic", "relative_range")])
def test_mapper_matches_jax(trees, kind, crop):
    """Each mapper on the Cityscapes records of its recipe, several seeds:
    the crop record, labels, masks and valid flags equal, the image within a
    grey level; the category-area retry loop runs."""
    overrides = SMALL_INPUT + ["INPUT.CROP.TYPE", crop]
    if crop == "relative_range":
        overrides += ["INPUT.CROP.SIZE", "(0.5, 0.9)", "INPUT.MIN_SIZE_TRAIN_SAMPLING", "range"]
    jcfg, tcfg = _cfgs(CITYSCAPES[kind], overrides)
    with mock.patch.object(JaxDatasetCatalog, "_registry", {}), \
            mock.patch.object(JaxMetadataCatalog, "_meta", {}):
        jax_register.register_all(trees["png"])
        records = JaxDatasetCatalog.get(jcfg.DATASETS.TRAIN[0])
    jmapper = getattr(jax_mappers, MAPPER[kind])(jcfg, True, 20)
    tmapper = getattr(mappers, MAPPER[kind])(tcfg, True, 20)
    unique = np.unique
    retries = []

    def counted(*a, **k):
        retries.append(1)
        return unique(*a, **k)

    n_targets = 0
    for rec in records:
        for seed in range(4):
            h, w = cv2.imread(rec["file_name"]).shape[:2]
            sem = cv2.imread(rec["sem_seg_file_name"], cv2.IMREAD_UNCHANGED) \
                if kind == "semantic" else None
            with mock.patch.object(mappers.np, "unique", counted):
                got_rec = tmapper._geometry(np.random.RandomState(seed), h, w, sem)
            assert vars(got_rec) == vars(jmapper._geometry(np.random.RandomState(seed), h, w, sem))
            want = jmapper(rec, np.random.RandomState(seed))
            got = tmapper(_port_record(rec), np.random.RandomState(seed))
            for key in ("labels", "valid", "masks", "boxes"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got["image"].shape == want["image"].shape
            diff = np.abs(got["image"].astype(np.int16) - want["image"].astype(np.int16))
            assert diff.max() <= GREY_LEVELS
            if kind == "semantic":
                np.testing.assert_array_equal(got["sem_seg"], want["sem_seg"])
            n_targets += int(got["valid"].sum())
    assert n_targets > len(records)  # the comparison is not of empty targets
    if kind == "semantic":
        assert len(retries) > 4 * len(records)  # some crop was drawn again


def _metadata(meta):
    return {k: v for k, v in vars(meta).items() if k != "name"}


def test_registrations_match_jax_and_npy_twins_pair(trees):
    """`register_all` and `register_more` under both packages on the PNG tree:
    the same names (LVIS v1 included), records and metadata; on the `.npy`
    tree the port's records are those with every file through its twin."""
    def registered(register_all, register_more, dataset_catalog, metadata_catalog, root):
        def load(name):  # the tree has no COCO: its panoptic json is missing in both
            try:
                return dataset_catalog.get(name)
            except FileNotFoundError as e:
                return f"missing {os.path.basename(e.filename)}"

        with mock.patch.object(dataset_catalog, "_registry", {}), \
                mock.patch.object(metadata_catalog, "_meta", {}):
            register_all(root)
            register_more(root)
            return {n: (load(n), _metadata(metadata_catalog.get(n)))
                    for n in dataset_catalog.list()}

    want = registered(jax_register.register_all, jax_register.register_more, JaxDatasetCatalog,
                      JaxMetadataCatalog, trees["png"])
    got = registered(port_register.register_all, port_register.register_more, DatasetCatalog,
                     MetadataCatalog, trees["png"])
    assert set(got) == set(want) and {"lvis_v1_train", "lvis_v1_val"} <= set(got)
    sizes = {}
    for name, (records, meta) in got.items():
        assert records == want[name][0], name
        assert meta == want[name][1], name
        sizes[name] = len(records)
    for name in ("ade20k_sem_seg_train", "ade20k_instance_val", "ade20k_panoptic_train",
                 "cityscapes_fine_sem_seg_val", "cityscapes_fine_instance_seg_train",
                 "cityscapes_fine_panoptic_val", "mapillary_vistas_sem_seg_train",
                 "mapillary_vistas_panoptic_val"):
        assert sizes[name] > 0, name

    on_npy = registered(port_register.register_all, port_register.register_more, DatasetCatalog,
                        MetadataCatalog, trees["npy"])
    swap = lambda s: s.replace(trees["png"], trees["npy"])  # noqa: E731
    files = ("file_name", "sem_seg_file_name", "pan_seg_file_name", "instance_id_file",
             "label_id_file")
    for name, (records, _) in got.items():
        twins = on_npy[name][0]
        if isinstance(records, str):
            assert twins == records
            continue
        assert len(twins) == len(records), name
        for a, b in zip(records, twins):
            for k in files:
                if k in a:
                    assert b[k] == npy_twin(swap(a[k])) and os.path.isfile(b[k]), (name, k)
            assert {k: v for k, v in a.items() if k not in files} == \
                {k: v for k, v in b.items() if k not in files}, name
