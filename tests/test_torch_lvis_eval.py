"""The port's LVIS evaluation (ROADMAP A16c) against the JAX package's and
the lvis-api oracle: `LVISEvaluator` on `tests/test_lvis_differential.py`'s
180 random draws (federated categories, not-exhaustive images, the cap of
detections an image across categories, APr / APc / APf), every summary key
exactly equal to the JAX evaluator's and within 1e-9 of the oracle's; COCO
AP unchanged with the federated arguments left at None; `lvis_v1_*`
registered as the JAX package registers them; and `--eval-only` of the
entry point scoring a synthetic LVIS split on the CPU."""

import json
import os

import numpy as np
import pytest
from unittest import mock

from mp_former_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from mp_former_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from mp_former_tpu.data.datasets import register_all as jax_register
from mp_former_tpu.evaluation.evaluators import COCOEvaluator as JaxCOCOEvaluator
from mp_former_tpu.evaluation.lvis_eval import LVISEvaluator as JaxLVISEvaluator

from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.data.datasets import register_all as port_register
from mp_former_tpu_torch.evaluation.coco_eval import COCOEvaluator
from mp_former_tpu_torch.evaluation.lvis_eval import LVISEvaluator

from oracle_lvis import LVISevalOracle
from test_lvis_differential import _rand_dataset

KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc", "APf")
CHUNK = 60  # three cases: the file stays at 6 tests (ROADMAP.md, "Tier-1's clock")


def _scores(cls, records, jf, preds, max_dets):
    ev = cls(records, jf, max_dets=max_dets)
    for img, (scores, classes, masks) in preds.items():
        ev.process(img, scores, classes, masks)
    return ev.evaluate()["segm"]


@pytest.mark.parametrize("first", range(0, 180, CHUNK))
def test_lvis_evaluator_matches_jax_and_oracle(first, tmp_path):
    """Seeds `first` .. `first` + 59 of the JAX differential (seeds from 120
    on with its max_dets 3, which exercises the cap across categories)."""
    compared = 0
    for seed in range(first, first + CHUNK):
        rng = np.random.RandomState(seed)
        jf, records, preds, gts_o, dts_o, img_info, cat_freq = _rand_dataset(rng, tmp_path)
        if not gts_o:
            continue
        max_dets = 3 if seed >= 120 else 300
        got = _scores(LVISEvaluator, records, jf, preds, max_dets)
        want = _scores(JaxLVISEvaluator, records, jf, preds, max_dets)
        oracle = LVISevalOracle(gts_o, dts_o, img_info, cat_freq, max_dets=max_dets)
        oracle.evaluate()
        oracle.accumulate()
        oracle_want = oracle.summarize()
        for k in KEYS:
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), (seed, k)
            if not (np.isnan(got[k]) and np.isnan(oracle_want[k])):
                np.testing.assert_allclose(got[k], oracle_want[k], rtol=1e-9, atol=1e-9,
                                           err_msg=f"seed={seed} {k}")
        compared += 1
    assert compared > 0


def test_coco_ap_unchanged_with_federated_arguments_unset():
    """COCOEvaluator of both packages on polygon ground truth with crowds and
    noisy predictions: the federated arguments default to None and every
    key stays the JAX one."""
    from mp_former_tpu_torch.native import polygons_to_mask

    rng = np.random.RandomState(0)
    h = w = 40
    records, preds = [], []
    for i in range(6):
        annos, masks = [], []
        for _ in range(rng.randint(1, 5)):
            x0, y0 = rng.randint(0, 30, 2)
            x1, y1 = x0 + rng.randint(4, 12), y0 + rng.randint(4, 12)
            poly = [float(v) for v in (x0, y0, x1, y0, x1, y1, x0, y1)]
            annos.append({"category_id": int(rng.randint(3)), "iscrowd": int(rng.rand() < 0.2),
                          "segmentation": [poly]})
            masks.append(polygons_to_mask([poly], h, w) ^ (rng.rand(h, w) < 0.05))
        masks += [rng.rand(h, w) < 0.1 for _ in range(3)]
        records.append({"image_id": i, "height": h, "width": w, "annotations": annos})
        preds.append((i, rng.rand(len(masks)), rng.randint(0, 3, len(masks)), masks))
    got, want = COCOEvaluator(records), JaxCOCOEvaluator(records)
    for ev in (got, want):
        for i, s, c, m in preds:
            ev.process(i, s, c, m)
    g, wnt = got.evaluate()["segm"], want.evaluate()["segm"]
    assert g.keys() == wnt.keys() and all(
        g[k] == wnt[k] or (np.isnan(g[k]) and np.isnan(wnt[k])) for k in g), (g, wnt)
    assert 0 < g["AP"] < 100


def test_lvis_registrations_match_jax(tmp_path):
    """`lvis_v1_{train,val}` in both packages on a synthetic LVIS split: the
    same records (the image named by its `coco_url` under `coco/`, the
    `.npy` twin in the port) and metadata (`evaluator_type` lvis, the json)."""
    from tools.make_synthetic_lvis_torch import write_lvis

    root = str(tmp_path)
    for split in ("train", "val"):
        write_lvis(root, split, images=2, size=48, classes=4, seed=3)
    got, want = {}, {}
    for register, catalog, meta, out in (
            (port_register.register_all, DatasetCatalog, MetadataCatalog, got),
            (jax_register.register_all, JaxDatasetCatalog, JaxMetadataCatalog, want)):
        with mock.patch.object(catalog, "_registry", {}), mock.patch.object(meta, "_meta", {}):
            register(root)
            for name in ("lvis_v1_train", "lvis_v1_val"):
                out[name] = (catalog.get(name),
                             {k: v for k, v in vars(meta.get(name)).items() if k != "name"})
    for name in got:
        recs, md = got[name]
        assert md == want[name][1]
        assert md["evaluator_type"] == "lvis"
        for r, w in zip(recs, want[name][0]):
            assert r["file_name"] == w["file_name"][:-len(".jpg")] + ".npy"
            assert os.path.isfile(r["file_name"])
            assert {k: v for k, v in r.items() if k != "file_name"} == \
                {k: v for k, v in w.items() if k != "file_name"}
        assert len(recs) == 2


def test_entry_point_scores_lvis(tmp_path):
    """`train_net.main --eval-only` on `lvis_v1_val` (a synthetic split with
    1203 categories) with the small model: AP, APr, APc and APf come out
    finite, through `build_evaluator`'s LVIS branch."""
    import torch

    from mp_former_tpu_torch import train_net
    from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
    from mp_former_tpu_torch.models import build_model
    from test_torch_slice import SMALL
    from tools.make_synthetic_lvis_torch import write_lvis

    root = str(tmp_path / "data")
    jf = write_lvis(root, "val", images=2, size=64, classes=4, seed=1)
    with open(jf) as f:
        assert len(json.load(f)["categories"]) == 1203
    overrides = [*SMALL, "MODEL.SEM_SEG_HEAD.NUM_CLASSES", "1203", "DATASETS.TEST",
                 "('lvis_v1_val',)", "MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp_path / "out")]
    args = train_net.default_argument_parser().parse_args(
        ["--eval-only", "--config-file",
         "configs/coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml",
         *overrides, "MODEL.WEIGHTS", str(tmp_path / "w.pth")])
    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(overrides)
    torch.save({"model": build_model(cfg).state_dict()}, tmp_path / "w.pth")
    with mock.patch.object(DatasetCatalog, "_registry", {}), \
            mock.patch.object(MetadataCatalog, "_meta", {}):
        port_register.register_all(root)
        res = train_net.main(args)
    segm = res["segm"]
    for k in ("AP", "APr", "APc", "APf"):
        assert np.isfinite(segm[k]), (k, segm)
