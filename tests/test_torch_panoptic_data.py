"""The port's COCO panoptic data layer against the JAX package: `rgb2id`, the
nearest resize of integer maps against cv2's INTER_NEAREST, the
`coco_panoptic_lsj` mapper on the same records and RandomState, and the
panoptic registration's records and metadata, on a dataset written by
`tools/make_synthetic_coco_torch.py --panoptic`.

The JAX mapper reads .png files with cv2 (the id map as the RGB encoding of
COCO panoptic), the port the same pixels and ids as .npy. Labels, masks and
valid flags must be equal; the image within one grey level (cv2 resizes uint8
in fixed point, the port rounds a float32 `F.interpolate`).
"""

import json

import cv2
import numpy as np
import pytest
import torch

from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from mp_former_tpu.data.dataset_mappers.mask_former_mappers import (
    COCOPanopticNewBaselineDatasetMapper as JaxMapper, rgb2id as jax_rgb2id)
from mp_former_tpu.data.datasets.register_all import (
    load_coco_panoptic_json as jax_load_coco_panoptic_json)

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.data.catalog import MetadataCatalog
from mp_former_tpu_torch.data.dataset_mappers.coco_panoptic_new_baseline import (
    COCOPanopticNewBaselineDatasetMapper, read_id_map, rgb2id)
from mp_former_tpu_torch.data.datasets.register_all import load_coco_panoptic_json
from mp_former_tpu_torch.data.transforms import resize_nearest
from mp_former_tpu_torch.utils.registry import DATASET_MAPPER_REGISTRY

from tools.make_synthetic_coco_torch import write_dataset

torch.set_num_threads(2)

GREY_LEVELS = 1
CONFIG = "configs/coco/panoptic-segmentation/maskformer2_R50_bs16_50ep.yaml"


def _cfgs(overrides):
    out = []
    for get, deeplab, mf2 in ((jax_get_cfg, jax_add_deeplab, jax_add_mf2),
                              (get_cfg, add_deeplab_config, add_maskformer2_config)):
        cfg = get()
        deeplab(cfg)
        mf2(cfg)
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(overrides)
        out.append(cfg)
    return out


def _id2rgb(ids):
    return np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """10 images of 80x80 with their panoptic ground truth as .npy (the
    port's) and as .png (the JAX package's: image BGR, id map RGB-encoded)."""
    root = tmp_path_factory.mktemp("torch_panoptic_data")
    write_dataset(str(root), images=10, size=80, classes=4, split="val2017", seed=2,
                  panoptic=True)
    coco = root / "coco"
    for stem in (p.stem for p in (coco / "val2017").glob("*.npy")):
        cv2.imwrite(str(coco / "val2017" / f"{stem}.png"), np.load(coco / "val2017" / f"{stem}.npy"))
        ids = np.load(coco / "panoptic_val2017" / f"{stem}.npy").astype(np.int64)
        cv2.imwrite(str(coco / "panoptic_val2017" / f"{stem}.png"), _id2rgb(ids)[..., ::-1])
    return root


def test_rgb2id_and_nearest_resize_match_the_reference():
    rng = np.random.RandomState(0)
    color = rng.randint(0, 256, (7, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(rgb2id(color), jax_rgb2id(color))
    assert rgb2id(_id2rgb(np.array([1, 256, 65536, 16777215]))).tolist() == [1, 256, 65536,
                                                                            16777215]
    for h, w, nh, nw in ((13, 17, 40, 23), (40, 33, 9, 14), (50, 50, 64, 64), (64, 64, 13, 50)):
        ids = rng.randint(0, 1 << 24, (h, w)).astype(np.int32)
        want = cv2.resize(ids, (nw, nh), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest(ids, nh, nw), want)


def test_registration_matches_jax(dataset):
    coco = dataset / "coco"
    args = (str(coco / "annotations/panoptic_val2017.json"), str(coco / "val2017"),
            str(coco / "panoptic_val2017"))
    kw = dict(semseg_root=str(coco / "panoptic_semseg_val2017"),
              instances_json=str(coco / "annotations/instances_val2017.json"))
    got = load_coco_panoptic_json(*args, "torch_panoptic_reg", **kw)
    want = jax_load_coco_panoptic_json(*args, "torch_panoptic_reg", **kw)
    assert len(got) == 10 and got == want
    assert all(r["annotations"] and r["sem_seg_file_name"].endswith(".npy") for r in got)
    mine, theirs = MetadataCatalog.get("torch_panoptic_reg"), JaxMetadataCatalog.get(
        "torch_panoptic_reg")
    for key in ("panoptic_classes", "stuff_classes", "thing_classes", "dataset_id_to_contiguous_id",
                "thing_dataset_id_to_contiguous_id", "thing_map"):
        assert mine.get(key) == theirs.get(key), key
    assert mine.get("thing_map") == {0: True, 1: True, 2: True, 3: True, 4: False}
    # the semantic map follows the id map and the contiguous ids; no void here
    rec = got[0]
    ids, sem = read_id_map(rec["pan_seg_file_name"]), np.load(rec["sem_seg_file_name"])
    for seg in rec["segments_info"]:
        assert (sem[ids == seg["id"]] == seg["category_id"]).all()
    assert sem.dtype == np.uint8 and (sem != 255).all()


@pytest.mark.parametrize("stride", ["4", "1"])
def test_panoptic_mapper_matches_jax(dataset, stride):
    """Over 3 draws of each record: flipped and not, up- and down-scaled,
    cropped and padded; one segment a crowd (skipped by both), and the
    max_instances cap reached."""
    jcfg, tcfg = _cfgs(["INPUT.IMAGE_SIZE", "64", "TPU.GT_MASK_STRIDE", stride])
    assert DATASET_MAPPER_REGISTRY.get("coco_panoptic_lsj") is COCOPanopticNewBaselineDatasetMapper
    coco = dataset / "coco"
    records = load_coco_panoptic_json(str(coco / "annotations/panoptic_val2017.json"),
                                      str(coco / "val2017"), str(coco / "panoptic_val2017"))
    theirs, ours = JaxMapper(jcfg, max_instances=5), COCOPanopticNewBaselineDatasetMapper(
        tcfg, max_instances=5)
    s, seen = int(stride), set()
    for k in range(3):
        for prec in records:
            prec["segments_info"][1]["iscrowd"] = 1
            jrec = dict(prec, file_name=prec["file_name"][:-4] + ".png",
                        pan_seg_file_name=prec["pan_seg_file_name"][:-4] + ".png")
            seed = 100 * k + prec["image_id"]
            want = theirs(jrec, np.random.RandomState(seed))
            got = ours(prec, np.random.RandomState(seed))
            assert got["masks"].shape == want["masks"].shape == (5, 64 // s, 64 // s)
            assert got["labels"].dtype == np.int64 and got["masks"].dtype == bool
            np.testing.assert_array_equal(got["labels"], want["labels"])
            np.testing.assert_array_equal(got["valid"], want["valid"])
            np.testing.assert_array_equal(got["masks"], want["masks"])
            np.testing.assert_array_equal(got["boxes"], want["boxes"])
            assert got["image"].dtype == np.uint8 and got["image"].shape == (64, 64, 3)
            assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= GREY_LEVELS
            for key in ("image_id", "height", "width"):
                assert got[key] == want[key]
            seen.add("cap" if want["valid"].all() else "room")
            seen.add("stuff" if 4 in got["labels"][got["valid"]] else "no stuff")
    assert seen == {"cap", "room", "stuff"}
    # an unreadable id map: the record is skipped, as an unreadable image is
    assert ours(dict(records[0], pan_seg_file_name="/nonexistent/0.npy"),
                np.random.RandomState(0)) is None


def test_tool_writes_one_dataset_with_or_without_panoptic(tmp_path):
    """--panoptic adds files; the images and the instance json stay those of
    the same seed without it, and every segment's area is its pixels in the
    id map."""
    a = write_dataset(str(tmp_path / "a"), images=3, size=48, classes=3, seed=5)
    b = write_dataset(str(tmp_path / "b"), images=3, size=48, classes=3, seed=5, panoptic=True)
    assert json.load(open(a)) == json.load(open(b))
    pan = json.load(open(tmp_path / "b/coco/annotations/panoptic_train2017.json"))
    assert pan["categories"][-1] == {"id": 4, "name": "background", "isthing": 0}
    for ann in pan["annotations"]:
        ids = np.load(tmp_path / "b/coco/panoptic_train2017" / ann["file_name"])
        assert ids.dtype == np.uint32
        assert sorted(np.unique(ids).tolist()) == sorted(s["id"] for s in ann["segments_info"])
        for seg in ann["segments_info"]:
            assert seg["area"] == (ids == seg["id"]).sum()
        np.testing.assert_array_equal(
            np.load(tmp_path / "a/coco/train2017" / ann["file_name"]),
            np.load(tmp_path / "b/coco/train2017" / ann["file_name"]))
