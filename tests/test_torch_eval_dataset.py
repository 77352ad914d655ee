"""`inference_on_dataset` and `run_evaluation` of the port on the small
TPU-recipe model with carried weights against the JAX package's
(tests/test_torch_eval.py holds the evaluators and the record loader). The
images are sized so that the test-time resize is the identity (cv2 on one
side, F.interpolate on the other), and the JAX canvases are bucketed by 32 so
that both sides pad to the same canvas. Six tests at most a file: the Tier-1 run queues
such files behind its longest one (ROADMAP.md, "Tier-1's clock").
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from mp_former_tpu.data.datasets.coco import register_coco_instances as jax_register_coco_instances
from mp_former_tpu.engine.eval_loop import inference_on_dataset as jax_inference_on_dataset
from mp_former_tpu.engine.eval_loop import run_evaluation as jax_run_evaluation
from mp_former_tpu.evaluation.evaluators import COCOEvaluator as JaxCOCOEvaluator

from mp_former_tpu_torch.data.datasets.coco import register_coco_instances
from mp_former_tpu_torch.engine.eval_loop import inference_on_dataset, run_evaluation
from mp_former_tpu_torch.engine.predictor import Predictor
from mp_former_tpu_torch.evaluation import coco_eval

from test_torch_eval import _fractional_polygon, _rle
from test_torch_headshare import FLOAT32, TPU_CONFIG
from test_torch_slice import SMALL, _build_pair

torch.set_num_threads(2)


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


def test_run_evaluation_matches_jax(eval_pair, tmp_path):
    """`run_evaluation` of a registered COCO-format dataset on disk (the
    port's images as .npy, the JAX package's as .png; ground truth as RLE and
    fractional polygons) gives the JAX `run_evaluation`'s AP within
    test_e2e_ap_oracle.py's 0.05, with MASK_FORMER.TEST.INSTANCE_ON off on
    both sides: the evaluators, not the switch, decide the tasks."""
    jcfg, jmodel, variables, tcfg, predictor, jax_records, _ = eval_pair
    rng = np.random.RandomState(3)
    images, annotations = {"png": [], "npy": []}, []
    for rec in jax_records:
        img = cv2.imread(rec["file_name"], cv2.IMREAD_COLOR)
        np.save(str(tmp_path / f"{rec['image_id']:03d}.npy"), img)
        for ext in images:
            images[ext].append({"id": rec["image_id"], "file_name": f"{rec['image_id']:03d}.{ext}",
                                "height": rec["height"], "width": rec["width"]})
        polygon = {"category_id": int(rng.randint(0, 3)), "iscrowd": 0,
                   "segmentation": [_fractional_polygon(rng, rec["height"], rec["width"])]}
        for a in rec["annotations"] + [polygon]:
            annotations.append({**a, "id": len(annotations) + 1, "image_id": rec["image_id"],
                                "category_id": a["category_id"] + 1, "bbox": [0, 0, 1, 1]})
    categories = [{"id": c + 1, "name": f"c{c}"} for c in range(80)]
    names = {}
    for ext, register in (("png", jax_register_coco_instances), ("npy", register_coco_instances)):
        path = tmp_path / f"instances_{ext}.json"
        path.write_text(json.dumps({"images": images[ext], "annotations": annotations,
                                    "categories": categories}))
        names[ext] = f"torch_run_evaluation_{ext}"
        # the .png images live beside the eval_pair fixture's records
        root = os.path.dirname(jax_records[0]["file_name"]) if ext == "png" else str(tmp_path)
        register(names[ext], str(path), root)
    jcfg = jcfg.clone()
    jcfg.merge_from_list(["TPU.EVAL_STREAM", "1", "MODEL.MASK_FORMER.TEST.INSTANCE_ON", "False"])
    tcfg = tcfg.clone()
    tcfg.merge_from_list(["MODEL.MASK_FORMER.TEST.INSTANCE_ON", "False"])
    model = predictor.model
    got = run_evaluation(tcfg, model, names["npy"], max_images=4)
    want = jax_run_evaluation(jcfg, jmodel, variables, names["png"], max_images=4)
    assert got.keys() == want.keys() == {"segm"}
    assert got["segm"]["AP"] > 20
    for key in ("AP", "AP50", "AP75"):
        assert abs(got["segm"][key] - want["segm"][key]) <= 0.05, key
