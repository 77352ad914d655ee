"""The port's panoptic and semantic evaluation against the JAX package: the PQ
and mIoU evaluators on the same maps, `build_evaluator` for a
`coco_panoptic_seg` dataset under every combination of the three
MASK_FORMER.TEST switches, and `run_evaluation` (PQ, mIoU and AP) and
`inference_on_dataset` (one task a call) end to end on a small panoptic
dataset, within 0.1 (the bound of tests/test_e2e_pq_miou_oracle.py).

The end-to-end dataset's ground truth is the port's own predictions of its
images (panoptic segments, their thing segments as instances, the semantic
argmax), at OBJECT_MASK_THRESHOLD 0.0 / OVERLAP_THRESHOLD 0.3 as in that
oracle test, so the scores sit far from 0 and any drift of canvas, crop,
resize, fusion or evaluator moves them. The port reads .npy files, the JAX
package the same pixels and maps as .png.
"""

import json
import logging

import cv2
import numpy as np
import pytest
import torch

from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from mp_former_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from mp_former_tpu.data.datasets.register_all import (
    register_coco_panoptic as jax_register_coco_panoptic)
from mp_former_tpu.engine.eval_loop import inference_on_dataset as jax_inference_on_dataset
from mp_former_tpu.engine.eval_loop import run_evaluation as jax_run_evaluation
from mp_former_tpu.evaluation.build import _load_sem_seg_gt as _jax_load_sem_seg_gt
from mp_former_tpu.evaluation.build import build_evaluator as jax_build_evaluator
from mp_former_tpu.evaluation.evaluators import COCOPanopticEvaluator as JaxCOCOPanopticEvaluator
from mp_former_tpu.evaluation.evaluators import SemSegEvaluator as JaxSemSegEvaluator
from mp_former_tpu.evaluation.panoptic_eval import PanopticEvaluator as JaxPanopticEvaluator

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.data.datasets.register_all import register_coco_panoptic
from mp_former_tpu_torch.engine.eval_loop import inference_on_dataset, run_evaluation
from mp_former_tpu_torch.engine.predictor import Predictor
from mp_former_tpu_torch.evaluation.build import _load_sem_seg_gt, build_evaluator
from mp_former_tpu_torch.evaluation.evaluators import COCOPanopticEvaluator, SemSegEvaluator
from mp_former_tpu_torch.evaluation.panoptic_eval import PanopticEvaluator

from test_panoptic_differential import _rand_panoptic
from test_torch_eval import _rle
from test_torch_slice import SMALL, _build_pair

torch.set_num_threads(2)

CONFIG = "configs/coco/panoptic-segmentation/maskformer2_R50_bs16_50ep.yaml"
K = 5
IS_THING = np.arange(K) % 2 == 0  # even classes things, odd ones stuff
PANOPTIC = SMALL + ["MODEL.SEM_SEG_HEAD.NUM_CLASSES", str(K),
                    "MODEL.MASK_FORMER.TEST.OBJECT_MASK_THRESHOLD", "0.0",
                    "MODEL.MASK_FORMER.TEST.OVERLAP_THRESHOLD", "0.3"]
SWITCHES = ("PANOPTIC_ON", "INSTANCE_ON", "SEMANTIC_ON")
# resized (h, w) equals the original: shortest edge 64, longest at most 96
SIZES = [(64, 96), (80, 64), (64, 72)]
SCORE_TOL = 0.1


def test_pq_and_miou_evaluators_match_jax():
    rng = np.random.RandomState(0)
    thing = {1: True, 2: False, 3: True}
    ours, theirs = PanopticEvaluator(thing), JaxPanopticEvaluator(thing)
    sem, jsem = SemSegEvaluator(4, 255), JaxSemSegEvaluator(4, 255)
    for _ in range(40):
        gt_map, gt_segments, pred_map, pred_segments = _rand_panoptic(rng)
        ours.process(pred_map, pred_segments, gt_map, gt_segments)
        theirs.process(pred_map, pred_segments, gt_map, gt_segments)
        pred = rng.randint(0, 4, (24, 20))
        gt = np.where(rng.rand(24, 20) < 0.1, 255, rng.randint(0, 4, (24, 20)))
        sem.process(pred, gt)
        jsem.process(pred, gt)
    got, want = ours.evaluate(), theirs.evaluate()
    assert set(got["panoptic_seg"]) == {"All", "Things", "Stuff"}
    assert got == want
    assert sem.evaluate() == jsem.evaluate()


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


def test_build_evaluator_matches_jax_under_every_switch(caplog):
    """The task lists of both packages for each of the 8 combinations; a
    split without semantic ground truth skips the semantic evaluator with a
    warning; where no evaluator is left both raise. LVIS raises in the port
    and names A16c."""
    records = [{"image_id": 0, "height": 4, "width": 4, "annotations": [],
                "pan_seg_file_name": "x.npy", "segments_info": []}]
    with_gt = [dict(records[0], sem_seg_file_name="y.npy")]
    for catalog, meta in ((DatasetCatalog, MetadataCatalog),
                          (JaxDatasetCatalog, JaxMetadataCatalog)):
        for name, recs in (("torch_pan_build", with_gt), ("torch_pan_build_no_gt", records)):
            if name not in catalog:
                catalog.register(name, lambda recs=recs: recs)
            meta.get(name).set(evaluator_type="coco_panoptic_seg", thing_map={0: True},
                               ignore_label=255)
    for bits in range(8):
        on = [str(bool(bits >> i & 1)) for i in range(3)]
        jcfg, tcfg = _cfgs([x for s, v in zip(SWITCHES, on)
                            for x in (f"MODEL.MASK_FORMER.TEST.{s}", v)])
        for name in ("torch_pan_build", "torch_pan_build_no_gt"):
            if bits == 0 or (bits == 4 and name.endswith("no_gt")):  # no evaluator left
                with pytest.raises(NotImplementedError):
                    build_evaluator(tcfg, name)
                with pytest.raises(NotImplementedError):
                    jax_build_evaluator(jcfg, name)
                continue
            with caplog.at_level(logging.WARNING):
                got = build_evaluator(tcfg, name)
            want = jax_build_evaluator(jcfg, name)
            assert got.tasks == want.tasks, (on, name)
            assert [e.task for e in got.entries] == [e.task for e in want.entries]
            if name.endswith("no_gt") and bits & 4:
                assert "semantic" not in got.tasks and "no sem_seg_file_name" in caplog.text
    MetadataCatalog.get("torch_pan_build_lvis").set(evaluator_type="lvis")
    with pytest.raises(NotImplementedError, match="A16c"):
        build_evaluator(tcfg, "torch_pan_build_lvis", records)


@pytest.fixture(scope="module")
def panoptic_dataset(tmp_path_factory):
    """3 images with ground truth from the port's own predictions, registered
    for the port (.npy) and for the JAX package (.png)."""
    jcfg, jmodel, params, tcfg, tmodel, _ = _build_pair(PANOPTIC, SIZES[0], CONFIG)
    predictor = Predictor(tcfg, model=tmodel, device="cpu", is_thing=IS_THING)
    assert predictor.tasks == ["instance", "semantic", "panoptic"]
    root = tmp_path_factory.mktemp("torch_panoptic_eval")
    for d in ("images", "pan", "sem"):
        (root / d).mkdir()
    rng = np.random.RandomState(3)
    images, pan_annotations, instances = {"npy": [], "png": []}, {"npy": [], "png": []}, []
    for i, (h, w) in enumerate(SIZES):
        # the JAX registration reads a .png image name as .jpg: both sides get
        # the pixels decoded from that file
        jpg = str(root / "images" / f"{i}.jpg")
        cv2.imwrite(jpg, rng.randint(0, 256, (h, w, 3), dtype=np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 100])
        img = cv2.imread(jpg, cv2.IMREAD_COLOR)
        np.save(str(root / "images" / f"{i}.npy"), img)
        out = predictor(img)
        pan_map, segments = out["panoptic_seg"]
        sem = out["sem_seg"].argmax(0).astype(np.uint8)
        rgb = np.stack([pan_map % 256, pan_map // 256 % 256, pan_map // 65536], -1).astype(np.uint8)
        for ext, save in (("npy", np.save), ("png", cv2.imwrite)):
            save(str(root / "pan" / f"{i}.{ext}"), pan_map.astype(np.uint32) if ext == "npy"
                 else rgb[..., ::-1])
            save(str(root / "sem" / f"{i}.{ext}"), sem)
            images[ext].append({"id": i, "file_name": f"{i}.{ext}", "height": h, "width": w})
            pan_annotations[ext].append({"image_id": i, "file_name": f"{i}.{ext}", "segments_info": [
                {"id": s["id"], "category_id": s["category_id"] + 1, "iscrowd": 0,
                 "area": int((pan_map == s["id"]).sum())} for s in segments]})
        instances += [{"id": len(instances) + 1, "image_id": i, "category_id": s["category_id"] + 1,
                       "iscrowd": 0, "bbox": [0, 0, 1, 1], "area": int((pan_map == s["id"]).sum()),
                       "segmentation": _rle(pan_map == s["id"])} for s in segments if s["isthing"]]
    assert sum(len(a["segments_info"]) for a in pan_annotations["npy"]) >= len(SIZES), \
        "the model made no panoptic segments: the comparison would be vacuous"
    categories = [{"id": c + 1, "name": f"c{c}", "isthing": int(IS_THING[c])} for c in range(K)]
    names = {}
    for ext, register in (("npy", register_coco_panoptic), ("png", jax_register_coco_panoptic)):
        for kind, data in (("panoptic", {"images": images[ext], "categories": categories,
                                         "annotations": pan_annotations[ext]}),
                           ("instances", {"images": images[ext], "categories": categories,
                                          "annotations": instances})):
            (root / f"{kind}_{ext}.json").write_text(json.dumps(data))
        names[ext] = f"torch_panoptic_eval_{ext}"
        register(names[ext], str(root / f"panoptic_{ext}.json"), str(root / "images"),
                 str(root / "pan"), semseg_root=str(root / "sem"),
                 instances_json=str(root / f"instances_{ext}.json"), ignore_label=255)
    jcfg = jcfg.clone()
    jcfg.merge_from_list(["TPU.EVAL_BUCKET_STEP", "32"])
    return jcfg, jmodel, {"params": params}, tcfg, tmodel, names


def test_run_evaluation_matches_jax_on_a_panoptic_dataset(panoptic_dataset):
    jcfg, jmodel, variables, tcfg, tmodel, names = panoptic_dataset
    got = run_evaluation(tcfg, tmodel, names["npy"])
    want = jax_run_evaluation(jcfg, jmodel, variables, names["png"])
    assert got.keys() == want.keys() == {"panoptic_seg", "sem_seg", "segm"}
    pairs = [(got["panoptic_seg"]["All"]["PQ"], want["panoptic_seg"]["All"]["PQ"]),
             (got["sem_seg"]["mIoU"], want["sem_seg"]["mIoU"]),
             (got["segm"]["AP"], want["segm"]["AP"])]
    # ground truth from the port's own predictions: PQ and mIoU are 100 up to
    # the pixels whose logits sit within rounding of a threshold
    assert pairs[0][0] > 95 and pairs[1][0] > 95 and pairs[2][0] > 20
    for g, w in pairs:
        assert abs(g - w) <= SCORE_TOL


def test_inference_on_dataset_semantic_and_panoptic_match_jax(panoptic_dataset):
    """One task a call, as the JAX package's `inference_on_dataset` takes it
    (`task`, `is_thing`, `sem_seg_loader`)."""
    jcfg, jmodel, variables, tcfg, tmodel, names = panoptic_dataset
    port_records, jax_records = DatasetCatalog.get(names["npy"]), JaxDatasetCatalog.get(names["png"])
    predictor = Predictor(tcfg, model=tmodel, device="cpu")  # is_thing from DATASETS.TEST: unused
    thing_map = dict(enumerate(IS_THING.tolist()))
    got = inference_on_dataset(tcfg, predictor, port_records, COCOPanopticEvaluator(thing_map),
                               task="panoptic", is_thing=IS_THING)
    want = jax_inference_on_dataset(jcfg, jmodel, variables, jax_records,
                                    JaxCOCOPanopticEvaluator(thing_map), task="panoptic",
                                    is_thing=IS_THING)
    for part in ("All", "Things"):
        for key in ("PQ", "SQ", "RQ"):
            assert abs(got["panoptic_seg"][part][key] - want["panoptic_seg"][part][key]) <= SCORE_TOL
    assert got["panoptic_seg"]["All"]["PQ"] > 95
    got = inference_on_dataset(tcfg, predictor, port_records, SemSegEvaluator(K, 255),
                               task="semantic", sem_seg_loader=_load_sem_seg_gt)
    want = jax_inference_on_dataset(jcfg, jmodel, variables, jax_records,
                                    JaxSemSegEvaluator(K, 255), task="semantic",
                                    sem_seg_loader=_jax_load_sem_seg_gt)
    assert abs(got["sem_seg"]["mIoU"] - want["sem_seg"]["mIoU"]) <= SCORE_TOL
    assert got["sem_seg"]["mIoU"] > 95
