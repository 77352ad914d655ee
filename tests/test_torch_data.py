"""The port's data layer against the JAX package: the LSJ transform and
mapper (`coco_instance_lsj`), the training loader, the COCO registration and
the numpy-only synthetic dataset tool.

The JAX mapper reads .png files with cv2 and the port the same pixels as
.npy; both rasterise polygons with pycocotools' rule (each its own build of
maskapi.cc). Targets must agree exactly. Images may differ by one grey level:
cv2 resizes uint8 in fixed point, the port rounds a float32 `F.interpolate`
(measured over the cases drawn here: at most 1).
"""

import json
import time

import cv2
import numpy as np
import pytest
import torch

from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.data import transforms as jax_transforms
from mp_former_tpu.data.dataset_mappers.coco_instance_new_baseline import (
    COCOInstanceNewBaselineDatasetMapper as JaxMapper)
from mp_former_tpu.data.loader import TrainLoader as JaxTrainLoader

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.data import transforms
from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.data.dataset_mappers.coco_instance_new_baseline import (
    COCOInstanceNewBaselineDatasetMapper, resize_nearest)
from mp_former_tpu_torch.data.datasets.coco import load_coco_json, register_all_coco
from mp_former_tpu_torch.data.loader import TrainLoader, build_train_loader, collate
from mp_former_tpu_torch.native import polygons_to_mask
from mp_former_tpu_torch.utils.registry import DATASET_MAPPER_REGISTRY

from test_torch_eval import _fractional_polygon, _rle
from tools.make_synthetic_coco_torch import class_color, write_dataset

torch.set_num_threads(2)

# the largest pixel difference of the port's resize against cv2's INTER_LINEAR
GREY_LEVELS = 1
CONFIG = "configs/coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml"


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


def test_lsj_records_match_jax():
    """The same RandomState draws give the same TransformRecord, field by
    field, and leave the state where the JAX package leaves it."""
    rng = np.random.RandomState(0)
    for _ in range(200):
        h, w = (int(v) for v in rng.randint(8, 1500, 2))
        size = int(rng.choice([64, 512, 1024]))
        lo, hi = sorted(rng.uniform(0.05, 2.5, 2))
        flip = bool(rng.rand() < 0.8)
        seed = int(rng.randint(1 << 30))
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        got = transforms.lsj_transform(a, h, w, size, lo, hi, flip)
        want = jax_transforms.lsj_transform(b, h, w, size, lo, hi, flip)
        assert vars(got) == vars(want)
        assert a.randint(1 << 30) == b.randint(1 << 30)


def test_image_transform_within_a_grey_level_of_cv2():
    rng = np.random.RandomState(1)
    worst = 0
    for _ in range(40):
        h, w = (int(v) for v in rng.randint(10, 120, 2))
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        rec = jax_transforms.lsj_transform(np.random.RandomState(int(rng.randint(1 << 30))),
                                           h, w, 64, 0.1, 2.0)
        got = transforms.apply_record_to_image(img, transforms.TransformRecord(**vars(rec)))
        want = jax_transforms.apply_record_to_image(img, rec)
        assert got.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3)
        worst = max(worst, int(np.abs(got.astype(int) - want.astype(int)).max()))
    assert worst <= GREY_LEVELS


def test_nearest_resize_matches_cv2():
    rng = np.random.RandomState(2)
    for _ in range(500):
        h, w = (int(v) for v in rng.randint(1, 200, 2))
        nh, nw = (int(v) for v in rng.randint(1, 400, 2))
        m = rng.rand(h, w) < 0.5
        want = cv2.resize(m.astype(np.uint8), (nw, nh), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest(m, nh, nw), want.astype(bool))


def test_gt_mask_stride_and_any_pool_match_jax():
    for mode, stride in (("grid", 0), ("random", 0), ("grid", 2)):
        jcfg, tcfg = _cfgs(["TPU.POINT_SAMPLE_MODE", mode, "TPU.GT_MASK_STRIDE", str(stride)])
        assert transforms.resolve_gt_mask_stride(tcfg) == jax_transforms.resolve_gt_mask_stride(jcfg)
    m = np.random.RandomState(3).rand(37, 22) < 0.1
    for s in (1, 2, 4):
        np.testing.assert_array_equal(transforms.block_any_pool(m, s),
                                      jax_transforms.block_any_pool(m, s))


@pytest.fixture(scope="module")
def mapper_records(tmp_path_factory):
    """Images of 20-120 px as .png (JAX) and .npy (port), each with polygon
    (fractional, several parts), uncompressed-RLE and crowd annotations."""
    root = tmp_path_factory.mktemp("torch_mapper")
    rng = np.random.RandomState(4)
    jax_records, port_records = [], []
    for i in range(12):
        h, w = (int(v) for v in rng.randint(20, 121, 2))
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(root / f"{i}.png"), img)
        np.save(str(root / f"{i}.npy"), img)
        annos = []
        for k in range(rng.randint(2, 7)):
            polys = [_fractional_polygon(rng, h, w) for _ in range(rng.randint(1, 3))]
            if k % 3 == 1:  # the same object as uncompressed RLE
                seg = _rle(polygons_to_mask(polys, h, w))
            else:
                seg = polys
            annos.append({"category_id": int(rng.randint(0, 80)), "segmentation": seg,
                          "iscrowd": int(k % 4 == 3)})
        base = {"image_id": i, "height": h, "width": w, "annotations": annos}
        jax_records.append({**base, "file_name": str(root / f"{i}.png")})
        port_records.append({**base, "file_name": str(root / f"{i}.npy")})
    return jax_records, port_records


@pytest.mark.parametrize("stride", ["4", "1"])
def test_lsj_mapper_matches_jax(mapper_records, stride):
    """Labels, boxes, valid and masks equal the JAX mapper's exactly; the
    image within GREY_LEVELS. Over the draws: flipped and not, up- and
    down-scaled, cropped and padded, with the max_instances cap reached."""
    jcfg, tcfg = _cfgs(["INPUT.IMAGE_SIZE", "64", "INPUT.FORMAT", "RGB",
                        "TPU.GT_MASK_STRIDE", stride])
    assert DATASET_MAPPER_REGISTRY.get("coco_instance_lsj") is COCOInstanceNewBaselineDatasetMapper
    jax_records, port_records = mapper_records
    theirs, ours = JaxMapper(jcfg, max_instances=4), COCOInstanceNewBaselineDatasetMapper(
        tcfg, max_instances=4)
    seen = set()
    for k in range(3):
        for jrec, prec in zip(jax_records, port_records):
            seed = 100 * k + jrec["image_id"]
            want = theirs(jrec, np.random.RandomState(seed))
            got = ours(prec, np.random.RandomState(seed))
            s = int(stride)
            assert got["masks"].shape == want["masks"].shape == (4, 64 // s, 64 // s)
            assert got["labels"].dtype == np.int64 and got["masks"].dtype == bool
            np.testing.assert_array_equal(got["labels"], want["labels"])
            np.testing.assert_array_equal(got["valid"], want["valid"])
            np.testing.assert_array_equal(got["masks"], want["masks"])
            np.testing.assert_array_equal(got["boxes"], want["boxes"])
            assert got["image"].dtype == np.uint8 and got["image"].shape == (64, 64, 3)
            assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= GREY_LEVELS
            for key in ("image_id", "height", "width"):
                assert got[key] == want[key]
            rec = transforms.lsj_transform(np.random.RandomState(seed), prec["height"],
                                           prec["width"], 64, 0.1, 2.0)
            seen |= {"flip" if rec.flip else "no flip",
                     "up" if rec.scale_x > 1 else "down",
                     "crop" if rec.tx or rec.ty else "no crop",
                     "pad" if rec.scale_x * prec["width"] < 63 or rec.scale_y * prec["height"] < 63
                     else "full"}
            if want["valid"].all():
                seen.add("cap")
    assert seen == {"flip", "no flip", "up", "down", "crop", "no crop", "pad", "full", "cap"}


def test_mapper_skips_unreadable_records(mapper_records):
    _, tcfg = _cfgs(["INPUT.IMAGE_SIZE", "64"])
    mapper = COCOInstanceNewBaselineDatasetMapper(tcfg)
    rec = {**mapper_records[1][0], "file_name": "/nonexistent/0.npy"}
    assert mapper(rec, np.random.RandomState(0)) is None


def _order_mapper(rec, rng):
    """Shapes in two groups, some samples empty, some records unreadable."""
    i = rec["image_id"]
    if i % 7 == 6:
        return None
    return {"image": np.zeros((2 + i % 2, 2, 3), np.uint8), "valid": np.array([i % 5 != 0]),
            "id": i, "draw": int(rng.randint(1 << 30))}


def _ids(samples):
    return [(s["id"], s["draw"]) for s in samples]


def _drain_and_join(loader, seconds=5.0):
    """The JAX loader's close() only sets an event; a producer blocked on its
    full queue sees it once an item is taken."""
    loader.close()
    end = time.monotonic() + seconds
    while loader._thread.is_alive() and time.monotonic() < end:
        try:
            loader._q.get(timeout=0.05)
        except Exception:
            pass


def test_train_loader_order_matches_jax():
    records = [{"image_id": i} for i in range(23)]
    ours = TrainLoader(records, _order_mapper, 3, seed=5, num_workers=3, collate_fn=_ids)
    theirs = JaxTrainLoader(records, _order_mapper, 3, seed=5, num_workers=3, collate_fn=_ids)
    try:
        got = [next(ours) for _ in range(12)]
        want = [next(theirs) for _ in range(12)]
    finally:
        ours.close(timeout=1.0)
        _drain_and_join(theirs)
    assert got == want
    assert {i % 2 for batch in got for i, _ in batch} == {0, 1}
    assert not any(i % 5 == 0 or i % 7 == 6 for batch in got for i, _ in batch)


def test_train_loader_close_joins_a_blocked_producer():
    loader = TrainLoader([{"image_id": i} for i in range(4)], _order_mapper, 1, prefetch=1,
                         num_workers=2, filter_empty=False, collate_fn=_ids)
    end = time.monotonic() + 5
    while not loader._q.full() and time.monotonic() < end:
        time.sleep(0.01)
    assert loader._q.full()  # the producer now waits for room
    t0 = time.monotonic()
    loader.close(timeout=1.0)
    assert not loader._thread.is_alive()
    assert time.monotonic() - t0 < 1.0


def test_train_loader_surfaces_mapper_errors():
    def broken(rec, rng):
        raise ValueError("bad record")

    loader = TrainLoader([{"image_id": 0}], broken, 2, num_workers=1)
    try:
        with pytest.raises(RuntimeError, match="producer thread died") as e:
            next(loader)
        assert isinstance(e.value.__cause__, ValueError)
    finally:
        loader.close(timeout=1.0)
    assert not loader._thread.is_alive()


def test_collate_gives_a_batch_of_cpu_tensors(mapper_records):
    _, tcfg = _cfgs(["INPUT.IMAGE_SIZE", "64"])
    mapper = COCOInstanceNewBaselineDatasetMapper(tcfg, max_instances=5)
    batch = collate([mapper(r, np.random.RandomState(0)) for r in mapper_records[1][:2]])
    assert batch.images.dtype == torch.uint8 and batch.images.shape == (2, 64, 64, 3)
    t = batch.targets
    assert (t.labels.dtype, t.masks.dtype, t.boxes.dtype, t.valid.dtype) == (
        torch.int64, torch.bool, torch.float32, torch.bool)
    assert t.masks.shape == (2, 5, 16, 16)  # stride 4 under the grid point loss
    assert not batch.images.is_pinned()


def test_register_all_coco_and_build_train_loader(tmp_path, monkeypatch):
    """The coco_2017 names under a root (a name already registered is kept:
    the catalog entries are cleared first, as a caller with another root must
    do), and `build_train_loader` on them: one shape, the mapper's stride."""
    write_dataset(str(tmp_path), images=5, size=48, classes=3, split="train2017", seed=0)
    for name in ("coco_2017_train", "coco_2017_val"):
        monkeypatch.delitem(DatasetCatalog._registry, name, raising=False)
    register_all_coco(str(tmp_path))
    records = DatasetCatalog.get("coco_2017_train")
    assert len(records) == 5 and records[0]["file_name"].endswith("000000000001.npy")
    assert MetadataCatalog.get("coco_2017_train").evaluator_type == "coco"
    before = DatasetCatalog._registry["coco_2017_val"]
    register_all_coco(str(tmp_path / "elsewhere"))
    assert DatasetCatalog._registry["coco_2017_val"] is before
    _, tcfg = _cfgs(["INPUT.IMAGE_SIZE", "32", "SOLVER.IMS_PER_BATCH", "2",
                     "DATALOADER.NUM_WORKERS", "2", "TPU.MAX_INSTANCES", "6"])
    loader = build_train_loader(tcfg)
    try:
        batches = [next(loader) for _ in range(3)]
    finally:
        loader.close(timeout=2.0)
    assert not loader._thread.is_alive()
    for b in batches:
        assert b.images.shape == (2, 32, 32, 3) and b.targets.masks.shape == (2, 6, 8, 8)
        assert b.targets.valid.any(1).all()


def test_builtin_registers_coco_2017():
    from mp_former_tpu_torch.data.datasets import builtin  # noqa: F401

    for split in ("train", "val"):
        meta = MetadataCatalog.get(f"coco_2017_{split}")
        assert meta.json_file.endswith(f"coco/annotations/instances_{split}2017.json")


def test_synthetic_tool_paints_its_polygons(tmp_path):
    """Every annotation's polygon rasterises to exactly the pixels that show
    its colour where no later object covers it; classes keep their hue."""
    path = write_dataset(str(tmp_path), images=4, size=80, classes=6, split="val2017", seed=2)
    records = load_coco_json(path, str(tmp_path / "coco" / "val2017"))
    with open(path) as f:
        data = json.load(f)
    assert len(records) == 4 and data["categories"][0] == {"id": 1, "name": "shape-0"}
    for rec in records:
        img = np.load(rec["file_name"])
        assert img.dtype == np.uint8 and img.shape == (80, 80, 3)
        annos = rec["annotations"]
        assert 1 <= len(annos) <= 8
        covered = np.zeros((80, 80), bool)
        for a in reversed(annos):  # the last painted is on top
            m = polygons_to_mask(a["segmentation"], 80, 80)
            assert m.sum() == a["area"]
            visible = m & ~covered
            colours = np.unique(img[visible].reshape(-1, 3), axis=0)
            assert len(colours) == 1, "one flat colour an object"
            base = class_color(a["category_id"], 6)
            assert np.abs(colours[0].astype(int) - base).max() <= 25  # the colour jitter
            covered |= m
    hsv = [cv2.cvtColor(np.uint8([[[int(179 * c / 6), 230, 220]]]), cv2.COLOR_HSV2BGR)[0, 0]
           for c in range(6)]
    assert max(np.abs(class_color(c, 6) - hsv[c].astype(int)).max() for c in range(6)) <= 1
