"""Dataset evaluation of the port against the JAX package: the numpy COCO
evaluator on identical detections and ground truth, the COCO-json record
loader, the rasteriser and `read_image` (`inference_on_dataset` and
`run_evaluation` on the small TPU-recipe model with carried weights are in
tests/test_torch_eval_dataset.py).
"""

import json
import sys

import cv2
import numpy as np
import pytest
import torch

from mp_former_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
from mp_former_tpu.evaluation import coco_eval as jax_coco_eval
from mp_former_tpu.evaluation.evaluators import COCOEvaluator as JaxCOCOEvaluator
from mp_former_tpu import native as jax_native

from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.data.datasets.coco import load_coco_json, register_coco_instances
from mp_former_tpu_torch.engine import eval_loop
from mp_former_tpu_torch.evaluation import coco_eval
from mp_former_tpu_torch import native

torch.set_num_threads(2)


def _rect_mask(rng, h, w):
    y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
    m = np.zeros((h, w), bool)
    m[y0:y0 + rng.randint(4, h - y0), x0:x0 + rng.randint(4, w - x0)] = True
    return m


def _xywh(mask):
    ys, xs = np.nonzero(mask)
    return [xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1]


def _random_images(seed, n_images=6, h=40, w=56, n_cats=3):
    """Per image: ground truth (some crowd, areas over all three ranges) and
    detections (shifted copies of the ground truth plus random ones)."""
    rng = np.random.RandomState(seed)
    images = []
    for _ in range(n_images):
        g = rng.randint(0, 5)
        gt_masks = [_rect_mask(rng, h, w) for _ in range(g)]
        gt_cats = rng.randint(0, n_cats, g)
        gt_crowd = rng.rand(g) < 0.2
        det_masks = [np.roll(m, rng.randint(-2, 3), axis=rng.randint(0, 2)) for m in gt_masks]
        det_cats = np.where(rng.rand(g) < 0.8, gt_cats, rng.randint(0, n_cats, g))
        extra = rng.randint(0, 4)
        det_masks += [_rect_mask(rng, h, w) for _ in range(extra)]
        det_cats = np.concatenate([det_cats, rng.randint(0, n_cats, extra)]).astype(np.int64)
        scores = rng.rand(g + extra)
        images.append(dict(gt_masks=gt_masks, gt_cats=gt_cats.astype(np.int64), gt_crowd=gt_crowd,
                           det_masks=det_masks, det_cats=det_cats, scores=scores))
    return images


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_type", ["segm", "bbox"])
def test_ap_evaluator_matches_jax(seed, iou_type):
    ours = coco_eval.CocoAPEvaluator(iou_type, max_dets=5)
    theirs = jax_coco_eval.CocoAPEvaluator(iou_type, max_dets=5)
    for im in _random_images(seed):
        if iou_type == "segm":
            dets, gts, areas = im["det_masks"], im["gt_masks"], None
        else:
            dets = np.asarray([_xywh(m) for m in im["det_masks"]], np.float64).reshape(-1, 4)
            gts = np.asarray([_xywh(m) for m in im["gt_masks"]], np.float64).reshape(-1, 4)
            areas = np.asarray([m.sum() for m in im["gt_masks"]], np.float64)
        for ev in (ours, theirs):
            ev.add_image(im["scores"], im["det_cats"], dets, im["gt_cats"], gts,
                         im["gt_crowd"], areas)
    got, want = ours.summarize(), theirs.summarize()
    assert got.keys() == want.keys() == {"AP", "AP50", "AP75", "APs", "APm", "APl"}
    assert 0 < want["AP"] < 100
    np.testing.assert_equal(got, want)  # the same arithmetic: equal, NaNs included
    np.testing.assert_equal(ours.per_category_ap(), theirs.per_category_ap())


def test_iou_matrices_match_jax():
    im = _random_images(3, n_images=1)[0]
    while len(im["gt_masks"]) < 2:
        im = _random_images(len(im["scores"]) + 7, n_images=1)[0]
    np.testing.assert_array_equal(
        coco_eval.mask_iou(im["det_masks"], im["gt_masks"], im["gt_crowd"]),
        jax_coco_eval.mask_iou(im["det_masks"], im["gt_masks"], im["gt_crowd"]))
    dets = np.asarray([_xywh(m) for m in im["det_masks"]], np.float64)
    gts = np.asarray([_xywh(m) for m in im["gt_masks"]], np.float64)
    np.testing.assert_array_equal(coco_eval.box_iou(dets, gts, im["gt_crowd"]),
                                  jax_coco_eval.box_iou(dets, gts, im["gt_crowd"]))
    assert coco_eval.mask_iou([], im["gt_masks"], im["gt_crowd"]).shape == (0, len(gts))


def _rle(mask):
    """(H, W) bool -> uncompressed COCO RLE (column-major runs, background first)."""
    flat = mask.T.reshape(-1).astype(np.uint8)
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return {"size": list(mask.shape), "counts": ([0] if flat[0] else []) + runs}


def _records(images, h, w, as_rle):
    return [{"image_id": i, "height": h, "width": w, "annotations": [
        {"category_id": int(c), "iscrowd": int(k), "area": float(m.sum()),
         "segmentation": _rle(m) if as_rle else m}
        for m, c, k in zip(im["gt_masks"], im["gt_cats"], im["gt_crowd"])]}
        for i, im in enumerate(images)]


def test_dataset_evaluator_matches_jax():
    """Ground truth as arrays and as RLE in the port, as RLE in the JAX
    package: the same summary."""
    images = _random_images(4)
    results = []
    for cls, as_rle in ((coco_eval.COCOEvaluator, False), (coco_eval.COCOEvaluator, True),
                        (JaxCOCOEvaluator, True)):
        ev = cls(_records(images, 40, 56, as_rle), max_dets=5)
        for i, im in enumerate(images):
            ev.process(i, im["scores"], im["det_cats"], im["det_masks"])
        results.append(ev.evaluate())
    assert 0 < results[2]["segm"]["AP"] < 100
    np.testing.assert_equal(results[0], results[2])
    np.testing.assert_equal(results[1], results[2])


def _fractional_polygon(rng, h, w):
    """A polygon of 3-9 vertices with fractional coordinates, some off the
    canvas."""
    n = rng.randint(3, 10)
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(2, max(h, w) / 2, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1).reshape(-1).tolist()


def test_native_rasteriser_matches_jax():
    """The port's copy of maskapi.cc gives the JAX package's native masks bit
    for bit: fractional vertices, vertices off the canvas, objects of several
    parts, parts of fewer than 3 vertices (skipped), an empty list."""
    rng = np.random.RandomState(11)
    for _ in range(60):
        h, w = rng.randint(5, 70, 2)
        polys = [_fractional_polygon(rng, h, w) for _ in range(rng.randint(1, 4))]
        if rng.rand() < 0.2:
            polys.append([1.5, 2.5, 3.5, 4.5])  # 2 vertices
        got = native.polygons_to_mask(polys, h, w)
        assert got.dtype == bool and got.shape == (h, w)
        np.testing.assert_array_equal(got, jax_native.polygons_to_mask_native(polys, h, w))
    assert not native.polygons_to_mask([], 7, 9).any()


def test_polygon_ground_truth_is_rasterised():
    """Polygon ground truth is rasterised by pycocotools' rule, as the JAX
    evaluator does: the rectangle with corners (4, 3) and (20, 15) covers
    rows 3-14 and columns 4-19, 192 pixels, not the 221 of filling rounded
    vertices (fault C2), and scores 100 against exactly that mask."""
    poly = [[4.0, 3.0, 20.0, 3.0, 20.0, 15.0, 4.0, 15.0]]
    rec = {"image_id": 7, "height": 24, "width": 32, "annotations": [
        {"category_id": 1, "iscrowd": 0, "area": 192.0, "segmentation": poly}]}
    want = np.zeros((24, 32), bool)
    want[3:15, 4:20] = True
    np.testing.assert_array_equal(native.polygons_to_mask(poly, 24, 32), want)
    ev = coco_eval.COCOEvaluator([rec])
    ev.process(7, np.asarray([0.9]), np.asarray([1]), [want])
    assert ev.evaluate()["segm"]["AP"] == pytest.approx(100.0)


def test_polygon_ground_truth_matches_jax_evaluator():
    """Fault C2: on polygon ground truth with fractional vertices (crowd and
    not, several parts), the port's evaluator gives the JAX evaluator's IoU
    matrices and summary exactly. The detections are the ground truth shifted
    by up to a pixel, where the rasterisation decides the IoU."""
    rng = np.random.RandomState(5)
    h, w = 30, 44
    records, dets = [], []
    for i in range(6):
        annos, masks, cats = [], [], []
        for _ in range(rng.randint(1, 5)):
            polys = [_fractional_polygon(rng, h, w) for _ in range(rng.randint(1, 3))]
            m = jax_native.polygons_to_mask_native(polys, h, w)
            if not m.any():
                continue
            c = int(rng.randint(0, 3))
            annos.append({"category_id": c, "iscrowd": int(rng.rand() < 0.15),
                          "area": float(m.sum()), "segmentation": polys})
            masks.append(np.roll(m, rng.randint(-1, 2), axis=rng.randint(0, 2)))
            cats.append(c)
        records.append({"image_id": i, "height": h, "width": w, "annotations": annos})
        dets.append((rng.rand(len(masks)), np.asarray(cats, np.int64), masks))
    ours = coco_eval.COCOEvaluator(records, max_dets=10)
    theirs = JaxCOCOEvaluator(records, max_dets=10)
    for i, (scores, cats, masks) in enumerate(dets):
        ours.process(i, scores, cats, masks)
        theirs.process(i, scores, cats, masks)
    assert ours._ap._records.keys() == theirs._ap._records.keys()
    for c in theirs._ap._records:
        for a, b in zip(ours._ap._records[c], theirs._ap._records[c], strict=True):
            np.testing.assert_array_equal(a["ious"], b["ious"])
    got, want = ours.evaluate(), theirs.evaluate()
    assert 0 < want["segm"]["AP"] < 100
    np.testing.assert_equal(got, want)


def test_failed_rasteriser_build_raises(monkeypatch, tmp_path):
    """No g++, or a source g++ rejects: the build raises with the compiler's
    output, and polygon ground truth is not drawn some other way."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    monkeypatch.undo()
    broken = tmp_path / "maskapi.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()
    native.library.cache_clear()
    try:
        ev = coco_eval.COCOEvaluator([{"image_id": 1, "height": 8, "width": 8, "annotations": [
            {"category_id": 0, "segmentation": [[1, 1, 6, 1, 6, 6]]}]}])
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            ev.process(1, np.asarray([0.5]), np.asarray([0]), [np.ones((8, 8), bool)])
    finally:
        native.library.cache_clear()


def test_coco_json_records_match_jax(tmp_path):
    data = {
        "images": [{"id": 11, "file_name": "a.png", "height": 30, "width": 40},
                   {"id": 5, "file_name": "b.png", "height": 20, "width": 25}],
        "annotations": [
            {"id": 1, "image_id": 11, "category_id": 18, "bbox": [1, 2, 10, 8], "area": 80.0,
             "iscrowd": 0, "segmentation": [[1, 2, 11, 2, 11, 10, 1, 10]]},
            {"id": 2, "image_id": 11, "category_id": 3, "bbox": [0, 0, 5, 5], "iscrowd": 1,
             "segmentation": {"size": [30, 40], "counts": [10, 5, 1185]}}],
        "categories": [{"id": 18, "name": "dog"}, {"id": 3, "name": "car"}],
    }
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(data))
    got = load_coco_json(str(path), str(tmp_path), "torch_eval_json")
    assert got == jax_load_coco_json(str(path), str(tmp_path))
    assert [a["category_id"] for a in got[0]["annotations"]] == [1, 0]  # contiguous ids
    meta = MetadataCatalog.get("torch_eval_json")
    assert meta.thing_classes == ["car", "dog"]
    assert meta.thing_dataset_id_to_contiguous_id == {3: 0, 18: 1}
    register_coco_instances("torch_eval_registered", str(path), str(tmp_path))
    assert "torch_eval_registered" in DatasetCatalog
    assert DatasetCatalog.get("torch_eval_registered") == got
    with pytest.raises(ValueError, match="already registered"):
        register_coco_instances("torch_eval_registered", str(path), str(tmp_path))


def test_coco_json_without_file_name_matches_jax(tmp_path):
    """Images that carry only `coco_url` (LVIS v1) keep the split directory."""
    data = {"images": [{"id": 3, "height": 8, "width": 9,
                        "coco_url": "http://images.cocodataset.org/val2017/000000000003.jpg"}],
            "annotations": [], "categories": [{"id": 1, "name": "a"}]}
    path = tmp_path / "lvis.json"
    path.write_text(json.dumps(data))
    got = load_coco_json(str(path), str(tmp_path))
    assert got == jax_load_coco_json(str(path), str(tmp_path))
    assert got[0]["file_name"] == str(tmp_path / "val2017" / "000000000003.jpg")


def test_read_image(tmp_path, monkeypatch):
    img = np.random.RandomState(0).randint(0, 256, (12, 9, 3), dtype=np.uint8)
    assert eval_loop.read_image({"image": img, "file_name": "/nonexistent.png"}) is img
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(eval_loop.read_image({"file_name": path}), img)
    assert eval_loop.read_image({"file_name": str(tmp_path / "missing.png")}) is None
    npy = str(tmp_path / "x.npy")
    np.save(npy, img)
    bad = str(tmp_path / "bad.npy")
    np.save(bad, img.astype(np.float32))
    monkeypatch.setitem(sys.modules, "cv2", None)  # as where cv2 is not installed
    with pytest.raises(ImportError, match="needs cv2.*\"image\""):
        eval_loop.read_image({"file_name": path})
    # .npy: how images reach a machine without an image decoder
    np.testing.assert_array_equal(eval_loop.read_image({"file_name": npy}), img)
    assert eval_loop.read_image({"file_name": str(tmp_path / "missing.npy")}) is None
    with pytest.raises(ValueError, match="uint8"):
        eval_loop.read_image({"file_name": bad})
