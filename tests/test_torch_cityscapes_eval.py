"""The port's Cityscapes evaluators and its evaluator factory against the JAX
package.

- `CityscapesInstanceEvaluator` (AP over 0.50:0.05:0.95, AP50, the 100 px
  minimum, group regions, void, duplicate matches, score ties) and
  `CityscapesSemSegEvaluator` (IoU, iIoU, the category aggregates) on the
  random id maps of tests/test_cityscapes_differential.py and
  tests/test_cityscapes_semseg_differential.py: every result within 1e-9;
  also through the records' own `_gtFine` files (`.npy` for the port, PNG for
  the JAX package), and with a panoptic model's 19 trainIds mapped to the 8
  thing classes.
- `build_evaluator` for every evaluator type of the recipes under each of
  the 8 combinations of the MASK_FORMER.TEST switches: the same (task,
  evaluator class) entries in the same order; LVIS raises in the port and
  names A16c.
"""

from unittest import mock

import cv2
import numpy as np
import pytest

from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from mp_former_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from mp_former_tpu.evaluation.build import build_evaluator as jax_build_evaluator
from mp_former_tpu.evaluation.cityscapes_eval import (
    CityscapesInstanceEvaluator as JaxInstanceEvaluator,
    CityscapesSemSegEvaluator as JaxSemSegEvaluator)

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.data.datasets.cityscapes_labels import EVAL_LABELS
from mp_former_tpu_torch.evaluation.build import build_evaluator, cityscapes_thing_index
from mp_former_tpu_torch.evaluation.cityscapes_eval import (CityscapesInstanceEvaluator,
                                                            CityscapesSemSegEvaluator)

import test_cityscapes_differential as inst_fuzz
import test_cityscapes_semseg_differential as sem_fuzz

TOL = 1e-9
SWITCHES = ("PANOPTIC_ON", "INSTANCE_ON", "SEMANTIC_ON")
TYPES = ("sem_seg", "coco", "coco_panoptic_seg", "ade20k_panoptic_seg",
         "mapillary_vistas_panoptic_seg", "cityscapes_instance", "cityscapes_sem_seg",
         "cityscapes_panoptic_seg")


def _assert_results_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for task in want:
        assert got[task].keys() == want[task].keys(), task
        for k, v in want[task].items():
            if np.isnan(v):
                assert np.isnan(got[task][k]), k
            else:
                np.testing.assert_allclose(got[task][k], v, rtol=TOL, atol=1e-12, err_msg=k)


def test_instance_evaluator_matches_jax_on_random_maps():
    finite = 0
    for seed in range(60):
        rng = np.random.RandomState(seed)
        got, want = CityscapesInstanceEvaluator(), JaxInstanceEvaluator()
        for _ in range(rng.randint(1, 4)):
            inst, masks, scores, classes = inst_fuzz._rand_image(
                rng, tie_scores=seed % 3 == 0, n_classes=1 + seed % 8)
            got.process({}, scores, classes, masks, gt_instance_map=inst)
            want.process({}, scores, classes, masks, gt_instance_map=inst)
        g, w = got.evaluate(), want.evaluate()
        _assert_results_equal(g, w)
        finite += np.isfinite(g["segm"]["AP"])
    assert finite > 30


def test_semseg_evaluator_matches_jax_on_random_maps():
    for seed in range(60):
        rng = np.random.RandomState(seed)
        got, want = CityscapesSemSegEvaluator(), JaxSemSegEvaluator()
        for _ in range(rng.randint(1, 4)):
            gt, inst, pred = sem_fuzz._rand_image(rng)
            got.process(pred, {}, gt_label_map=gt, gt_instance_map=inst)
            want.process(pred, {}, gt_label_map=gt, gt_instance_map=inst)
        _assert_results_equal(got.evaluate(), want.evaluate())


def test_evaluators_read_the_records_gtfine_files(tmp_path):
    """The port reads `.npy` `_gtFine` maps, the JAX package the same maps as
    PNG; the semantic evaluator finds the labelIds and instanceIds beside
    the labelTrainIds path of a semantic record; a panoptic model's trainIds
    reach the instance evaluator as thing indices."""
    rng = np.random.RandomState(7)
    records = {"npy": [], "png": []}
    preds = []
    for i in range(3):
        gt, inst, pred = sem_fuzz._rand_image(rng)
        stem = str(tmp_path / f"city_{i:06d}_000019_gtFine_")
        for ext in ("npy", "png"):
            for kind, m in (("labelIds", gt.astype(np.uint8)), ("instanceIds", inst.astype(np.uint16)),
                            ("labelTrainIds", np.zeros_like(gt, np.uint8))):
                (np.save if ext == "npy" else cv2.imwrite)(f"{stem}{kind}.{ext}", m)
            records[ext].append({"sem_seg_file_name": f"{stem}labelTrainIds.{ext}",
                                 "instance_id_file": f"{stem}instanceIds.{ext}"})
        preds.append(pred)
    got, want = CityscapesSemSegEvaluator(), JaxSemSegEvaluator()
    for pred, t, j in zip(preds, records["npy"], records["png"]):
        got.process(pred, {"sem_seg_file_name": t["sem_seg_file_name"]})
        want.process(pred, {"sem_seg_file_name": j["sem_seg_file_name"]})
    _assert_results_equal(got.evaluate(), want.evaluate())
    assert np.isfinite(got.evaluate()["sem_seg"]["iIoU"])

    # the 19 trainIds of a panoptic model: the port maps them to the thing
    # indices; the JAX evaluator given those indices scores the same
    index = cityscapes_thing_index(
        {"thing_map": {lab.trainId: lab.hasInstances for lab in EVAL_LABELS}}, 19)
    assert index.tolist() == [-1] * 11 + list(range(8))
    got, want = CityscapesInstanceEvaluator(thing_index=index), JaxInstanceEvaluator()
    for t, j in zip(records["npy"], records["png"]):
        inst = np.load(t["instance_id_file"]).astype(np.int64)
        masks = [inst == g for g in np.unique(inst[inst >= 1000])] + [inst < 1000]
        train_ids = np.array([EVAL_LABELS.index(next(lab for lab in EVAL_LABELS
                                                     if lab.id == g // 1000))
                              for g in np.unique(inst[inst >= 1000])] + [0])
        scores = rng.rand(len(masks))
        got.process(t, scores, train_ids, masks)
        keep = index[train_ids] >= 0
        want.process(j, scores[keep], index[train_ids][keep], [m for m, k in zip(masks, keep) if k])
    g = got.evaluate()
    _assert_results_equal(g, want.evaluate())
    assert g["segm"]["AP"] == 100.0


def _cfgs(switches):
    overrides = [x for s, v in zip(SWITCHES, switches)
                 for x in (f"MODEL.MASK_FORMER.TEST.{s}", str(v))]
    out = []
    for get, deeplab, mf2 in ((jax_get_cfg, jax_add_deeplab, jax_add_mf2),
                              (get_cfg, add_deeplab_config, add_maskformer2_config)):
        cfg = get()
        deeplab(cfg)
        mf2(cfg)
        cfg.merge_from_list(["MODEL.SEM_SEG_HEAD.NUM_CLASSES", "19", *overrides])
        out.append(cfg)
    return out


def _entries(evset):
    return [(e.task, type(e.evaluator).__name__) for e in evset.entries]


@pytest.mark.parametrize("et", TYPES)
def test_build_evaluator_matches_jax_under_every_switch(et):
    record = {"image_id": 0, "height": 4, "width": 4, "annotations": [],
              "pan_seg_file_name": "x.npy", "segments_info": []}
    sets = {"gt": [dict(record, sem_seg_file_name="y.npy")], "no_gt": [record]}
    thing_map = {lab.trainId: lab.hasInstances for lab in EVAL_LABELS}
    with mock.patch.object(DatasetCatalog, "_registry", {}), \
            mock.patch.object(MetadataCatalog, "_meta", {}), \
            mock.patch.object(JaxDatasetCatalog, "_registry", {}), \
            mock.patch.object(JaxMetadataCatalog, "_meta", {}):
        for catalog, meta in ((DatasetCatalog, MetadataCatalog),
                              (JaxDatasetCatalog, JaxMetadataCatalog)):
            for name, recs in sets.items():
                catalog.register(name, lambda recs=recs: recs)
                meta.get(name).set(evaluator_type=et, thing_map=thing_map, ignore_label=255)
            catalog.register("lvis", lambda: [record])
            meta.get("lvis").set(evaluator_type="lvis")
        built = 0
        for bits in range(8):
            jcfg, tcfg = _cfgs([bool(bits >> i & 1) for i in range(3)])
            for name in sets:
                try:
                    want = _entries(jax_build_evaluator(jcfg, name))
                except NotImplementedError:
                    with pytest.raises(NotImplementedError):
                        build_evaluator(tcfg, name)
                    continue
                assert _entries(build_evaluator(tcfg, name)) == want, (bits, name)
                built += 1
        assert built > 0
        with pytest.raises(NotImplementedError, match="A16c"):
            build_evaluator(tcfg, "lvis")
