"""Dataset evaluation of the port against the JAX package: the numpy COCO
evaluator on identical detections and ground truth, the COCO-json record
loader, and `inference_on_dataset` on the small TPU-recipe model with carried
weights. The images are sized so that the test-time resize is the identity
(cv2 on one side, F.interpolate on the other), and the JAX canvases are
bucketed by 32 so that both sides pad to the same canvas.
"""

import json
import sys

import cv2
import numpy as np
import pytest
import torch

from mp_former_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
from mp_former_tpu.engine.eval_loop import inference_on_dataset as jax_inference_on_dataset
from mp_former_tpu.evaluation import coco_eval as jax_coco_eval
from mp_former_tpu.evaluation.evaluators import COCOEvaluator as JaxCOCOEvaluator

from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.data.datasets.coco import load_coco_json, register_coco_instances
from mp_former_tpu_torch.engine import eval_loop
from mp_former_tpu_torch.engine.eval_loop import inference_on_dataset
from mp_former_tpu_torch.engine.predictor import Predictor
from mp_former_tpu_torch.evaluation import coco_eval

from test_torch_headshare import FLOAT32, TPU_CONFIG
from test_torch_slice import SMALL, _build_pair

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


def test_polygon_ground_truth_is_rasterised():
    poly = [[4.0, 3.0, 20.0, 3.0, 20.0, 15.0, 4.0, 15.0]]
    rec = {"image_id": 7, "height": 24, "width": 32, "annotations": [
        {"category_id": 1, "iscrowd": 0, "area": 221.0, "segmentation": poly}]}
    want = np.zeros((24, 32), bool)
    want[3:16, 4:21] = True
    ev = coco_eval.COCOEvaluator([rec])
    ev.process(7, np.asarray([0.9]), np.asarray([1]), [want])
    assert ev.evaluate()["segm"]["AP"] == pytest.approx(100.0)


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


def test_read_image(tmp_path, monkeypatch):
    img = np.random.RandomState(0).randint(0, 256, (12, 9, 3), dtype=np.uint8)
    assert eval_loop.read_image({"image": img, "file_name": "/nonexistent.png"}) is img
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(eval_loop.read_image({"file_name": path}), img)
    assert eval_loop.read_image({"file_name": str(tmp_path / "missing.png")}) is None
    monkeypatch.setitem(sys.modules, "cv2", None)  # as where cv2 is not installed
    with pytest.raises(ImportError, match="needs cv2.*\"image\""):
        eval_loop.read_image({"file_name": path})


TOPK = 8
# resized (h, w) equals the original for each: shortest edge 64, longest at most 96
SIZES = [(64, 96), (64, 80), (64, 96), (64, 72), (64, 88)]


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    jcfg, jmodel, params, tcfg, tmodel, _ = _build_pair(SMALL + FLOAT32, (64, 96), TPU_CONFIG)
    jcfg = jcfg.clone()
    jcfg.merge_from_list(["TPU.EVAL_BUCKET_STEP", "32"])
    root = tmp_path_factory.mktemp("torch_eval")
    rng = np.random.RandomState(7)
    predictor = Predictor(tcfg, model=tmodel, device="cpu")
    jax_records, port_records = [], []
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        path = str(root / f"{i:03d}.png")
        cv2.imwrite(path, img)
        # ground truth: the port's own three best predictions of the image
        inst = predictor(img)["instances"]
        annos = [(int(inst["classes"][j]), inst["masks"][j])
                 for j in np.argsort(-inst["scores"])[:3] if inst["masks"][j].sum() > 40]
        base = {"file_name": path, "height": h, "width": w, "image_id": i}
        jax_records.append({**base, "annotations": [
            {"category_id": c, "iscrowd": 0, "area": float(m.sum()), "segmentation": _rle(m)}
            for c, m in annos]})
        port = {**base, "annotations": [
            {"category_id": c, "iscrowd": 0, "area": float(m.sum()), "segmentation": m}
            for c, m in annos]}
        if i % 2 == 0:  # every other record carries its decoded image
            port["image"] = img
        port_records.append(port)
    assert sum(len(r["annotations"]) for r in port_records) >= len(SIZES)
    return jcfg, jmodel, {"params": params}, tcfg, predictor, jax_records, port_records


def test_inference_on_dataset_matches_jax(eval_pair):
    jcfg, jmodel, variables, tcfg, predictor, jax_records, port_records = eval_pair
    got = inference_on_dataset(tcfg, predictor, port_records,
                               coco_eval.COCOEvaluator(port_records, max_dets=TOPK))
    want = jax_inference_on_dataset(jcfg, jmodel, variables, jax_records,
                                    JaxCOCOEvaluator(jax_records, max_dets=TOPK))
    assert got["segm"].keys() == want["segm"].keys()
    # the ground truth is the port's own predictions, so the AP is far from 0
    # and any drift in canvas, crop, resize order, top-k or rescoring moves
    # it. The two sides' masks can differ only in pixels whose logit is within
    # float32 noise of 0; the tolerance is that of tests/test_e2e_ap_oracle.py
    assert got["segm"]["AP"] > 30
    for key in ("AP", "AP50", "AP75"):
        assert abs(got["segm"][key] - want["segm"][key]) <= 0.05, key


def test_max_images_and_unreadable_records(eval_pair):
    _, _, _, tcfg, predictor, _, port_records = eval_pair
    records = [{"file_name": "/nonexistent/image.png", "image_id": 99, "height": 64,
                "width": 96, "annotations": []}] + port_records
    evaluator = coco_eval.COCOEvaluator(records, max_dets=TOPK)
    seen = []
    process = evaluator.process
    evaluator.process = lambda image_id, *a: (seen.append(image_id), process(image_id, *a))
    res = inference_on_dataset(tcfg, predictor, records, evaluator, max_images=2)
    assert seen == [0, 1]  # the unreadable record is skipped and does not count
    assert np.isfinite(res["segm"]["AP"])
