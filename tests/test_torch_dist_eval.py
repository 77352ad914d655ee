"""Evaluation and data across data-parallel ranks (`parallel/dist.py`, the
evaluators' `merge_from`, the loaders' rank blocks), after
`tests/test_two_process_distributed.py` for the JAX package.

Two gloo processes (`parallel/dist.py:launch`, one thread each) run
`all_gather_objects` on payloads of different sizes, `sharded_eval_loop`
with the JAX test's cap and mapper skip, and COCO AP through the loop
against one process; `batch_rows` draws and `gather_rows` against the
global batch's. In one process: every evaluator's `merge_from` of two
round-robin shards against one evaluator over all records and against the
JAX package's merge of the same shards; the loaders' rank blocks against
the one-process batch.

Tolerances: every summary key exactly equal (NaN where NaN), but PQ's, whose
IoU sums add in another order when merged: 1e-12 relative.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from mp_former_tpu_torch.parallel.dist import (all_gather_objects, all_reduce_sum,
                                               get_local_rank, get_rank, get_world_size,
                                               launch, sharded_eval_loop, synchronize)

torch.set_num_threads(2)


class CountingEvaluator:
    """Module-level so that it survives the pickle of `all_gather_objects`."""

    def __init__(self):
        self.seen = []

    def merge_from(self, other):
        self.seen.extend(other.seen)


def _coco_case(seed=0, images=6, h=40, w=40):
    """COCO records with polygon ground truth, crowds among them, and noisy
    predictions (`tests/test_torch_lvis_eval.py`'s case)."""
    from mp_former_tpu_torch.native import polygons_to_mask

    rng = np.random.RandomState(seed)
    records, preds = [], []
    for i in range(images):
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
    return records, preds


def _worker(out_dir):
    from mp_former_tpu_torch.evaluation.coco_eval import COCOEvaluator
    from mp_former_tpu_torch.parallel.rows import RowShard, batch_rows, draw, gather_rows

    torch.set_num_threads(1)
    rank, world = get_rank(), get_world_size()
    out = {"world": world, "local_rank": get_local_rank()}
    # payloads of different pickled sizes
    gathered = all_gather_objects({"rank": rank, "blob": "x" * (10 + 300 * rank)})
    out["gathered"] = [(g["rank"], len(g["blob"])) for g in gathered]
    out["sum"] = float(all_reduce_sum(torch.tensor([rank + 1.0]))[0])
    # 12 records capped at 10 round-robin, record 7 skipped by the mapper
    ev = CountingEvaluator()
    out["done"] = sharded_eval_loop(
        [{"id": i} for i in range(12)], ev, lambda rec: None if rec["id"] == 7 else rec,
        lambda rec: ev.seen.append(rec["id"]), max_records=10)
    out["seen"] = sorted(ev.seen)
    # COCO AP through the loop
    records, preds = _coco_case()
    coco = COCOEvaluator(records)
    sharded_eval_loop(preds, coco, lambda p: p, lambda p: coco.process(*p))
    out["coco"] = coco.evaluate()
    # draws of the global batch, this rank's rows
    with batch_rows(RowShard(2 * world, 2 * rank, 2)):
        g = torch.Generator().manual_seed(5)
        out["draw"] = draw(lambda s: torch.rand(s, generator=g), (2, 3), 0).tolist()
        out["gathered_rows"] = gather_rows(torch.tensor([[rank], [rank + 10]])).tolist()
    synchronize()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def test_sharded_eval_loop_and_collectives_over_two_processes(tmp_path):
    from mp_former_tpu_torch.evaluation.coco_eval import COCOEvaluator

    launch(_worker, 2, backend="gloo", args=(str(tmp_path),))
    results = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    records, preds = _coco_case()
    one = COCOEvaluator(records)
    for p in preds:
        one.process(*p)
    want = one.evaluate()
    # the cap counts raw records: rank 0 maps 0, 2, 4, 6, 8; rank 1 1, 3, 5, 9
    assert [r["done"] for r in results] == [5, 4]
    for rank, r in enumerate(results):
        assert r["world"] == 2 and r["local_rank"] == rank and r["sum"] == 3.0
        assert r["gathered"] == [[0, 10], [1, 310]]
        assert r["seen"] == [i for i in range(10) if i != 7]
        _equal(r["coco"], want)
        assert r["gathered_rows"] == [[0], [10], [1], [11]]
    assert 0 < want["segm"]["AP"] < 100
    full = torch.rand((4, 3), generator=torch.Generator().manual_seed(5))
    assert results[0]["draw"] + results[1]["draw"] == full.tolist()


def _equal(got: dict, want: dict, rtol=0.0):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            _equal(got[k], v, rtol)
        elif isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        elif rtol:
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=0, err_msg=k)
        else:
            assert got[k] == v, (k, got[k], v)


def _floats(d: dict):
    for v in d.values():
        yield from _floats(v) if isinstance(v, dict) else [v]


def _cases(tmp_path):
    """(name, port class, JAX class, constructor arguments, the calls of
    `process`, the tolerance: PQ's float sums add in another order) for
    every evaluator of the port."""
    import test_cityscapes_differential as inst_fuzz
    import test_cityscapes_semseg_differential as sem_fuzz
    from test_lvis_differential import _rand_dataset
    from test_panoptic_differential import _rand_panoptic

    from mp_former_tpu.evaluation import cityscapes_eval as jcity, evaluators as jev
    from mp_former_tpu.evaluation.lvis_eval import LVISEvaluator as JaxLVIS
    from mp_former_tpu.evaluation.panoptic_eval import PanopticEvaluator as JaxPQ
    from mp_former_tpu_torch.evaluation import cityscapes_eval as city, coco_eval, evaluators
    from mp_former_tpu_torch.evaluation.lvis_eval import LVISEvaluator
    from mp_former_tpu_torch.evaluation.panoptic_eval import PanopticEvaluator

    rng = np.random.RandomState(0)
    records, preds = _coco_case(seed=1, images=7)
    cases = [("coco", coco_eval.COCOEvaluator, jev.COCOEvaluator, (records,),
              [(p, {}) for p in preds], 0.0)]
    pq = [_rand_panoptic(rng) for _ in range(6)]
    cases.append(("panoptic", PanopticEvaluator, JaxPQ, (), [
        ((pm, ps, gm, gs), {}) for gm, gs, pm, ps in pq], 1e-12))
    sem = []
    for _ in range(5):
        gt = rng.randint(0, 6, (24, 24))
        gt[rng.rand(24, 24) < 0.1] = 255
        sem.append(((rng.randint(0, 6, (24, 24)), gt), {}))
    cases.append(("sem_seg", evaluators.SemSegEvaluator, jev.SemSegEvaluator, (6,), sem, 0.0))
    inst = []
    for _ in range(5):
        gmap, masks, scores, classes = inst_fuzz._rand_image(rng, n_classes=3)
        inst.append((({}, scores, classes, masks), {"gt_instance_map": gmap}))
    cases.append(("cityscapes_instance", city.CityscapesInstanceEvaluator,
                  jcity.CityscapesInstanceEvaluator, (), inst, 0.0))
    csem = []
    for _ in range(5):
        gt, imap, pred = sem_fuzz._rand_image(rng)
        csem.append(((pred, {}), {"gt_label_map": gt, "gt_instance_map": imap}))
    cases.append(("cityscapes_sem_seg", city.CityscapesSemSegEvaluator,
                  jcity.CityscapesSemSegEvaluator, (), csem, 0.0))
    jf, lrecords, lpreds, *_ = _rand_dataset(np.random.RandomState(3), tmp_path, n_imgs=5)
    cases.append(("lvis", LVISEvaluator, JaxLVIS, (lrecords, jf),
                  [((img, *p), {}) for img, p in lpreds.items()], 0.0))
    return cases


def _evaluate(cls, args, calls, shards=1):
    """Every call into one evaluator, or round-robin into `shards` of them
    merged into the first; its summary."""
    evs = [cls(*args) for _ in range(shards)]
    for i, (a, k) in enumerate(calls):
        evs[i % shards].process(*a, **k)
    for other in evs[1:]:
        evs[0].merge_from(other)
    return evs[0].evaluate()


def test_merge_from_equals_one_evaluator_and_the_jax_merge(tmp_path):
    """For every evaluator of the port (COCO AP, PQ, mIoU, both Cityscapes
    evaluators, LVIS; the COCO panoptic wrapper, the YTVIS evaluator and
    `EvaluatorSet` fold through theirs): two shards merged give the one
    evaluator's summary over all records, and the JAX package's merge of the
    same shards."""
    for name, cls, jcls, args, calls, rtol in _cases(tmp_path):
        one = _evaluate(cls, args, calls)
        merged = _evaluate(cls, args, calls, shards=2)
        _equal(merged, one, rtol)
        _equal(merged, _evaluate(jcls, args, calls, shards=2), rtol)
        assert any(np.isfinite(v) for v in _floats(one)), name


def test_wrappers_and_sets_merge_their_evaluators(tmp_path):
    """`COCOPanopticEvaluator`, `YTVISEvaluator` and `EvaluatorSet` merge
    what they hold; sets built from different configs refuse to merge."""
    from mp_former_tpu_torch.evaluation.build import EvaluatorSet, _Entry
    from mp_former_tpu_torch.evaluation.coco_eval import COCOEvaluator
    from mp_former_tpu_torch.evaluation.evaluators import COCOPanopticEvaluator, SemSegEvaluator
    from mp_former_tpu_torch.video.ytvis_eval import YTVISEvaluator
    from test_panoptic_differential import _rand_panoptic

    rng = np.random.RandomState(2)
    pan = [COCOPanopticEvaluator() for _ in range(2)]
    one = COCOPanopticEvaluator()
    for i in range(4):
        gm, gs, pm, ps = _rand_panoptic(rng)
        pan[i % 2]._pq.process(pm, ps, gm, gs)
        one._pq.process(pm, ps, gm, gs)
    pan[0].merge_from(pan[1])
    _equal(pan[0].evaluate(), one.evaluate(), 1e-12)

    h = w = 24
    videos, tubes = [], []
    for v in range(4):
        x0, y0, x1, y1 = 3, 4 + v, 12 + v, 14
        poly = [[float(c) for c in (x0, y0, x1, y0, x1, y1, x0, y1)]]
        videos.append({"video_id": v, "height": h, "width": w, "length": 2, "annotations": [
            {"category_id": v % 2, "iscrowd": 0, "segmentations": [poly, poly]}]})
        tube = np.zeros((2, h, w), bool)
        tube[:, y0:y1 + 1, x0 + v:x1 + v] = True
        tubes.append(tube)
    yt = [YTVISEvaluator(videos) for _ in range(3)]
    for v in videos:
        pred = tubes[v["video_id"]]
        for ev in (yt[v["video_id"] % 2], yt[2]):
            ev.process(v["video_id"], np.asarray([0.9, 0.3]), np.asarray([v["video_id"] % 2, 1]),
                       [pred, ~pred])
    yt[0].merge_from(yt[1])
    _equal(yt[0].evaluate(), yt[2].evaluate())
    assert 0 < yt[2].evaluate()["segm"]["AP"] < 100

    records, preds = _coco_case(seed=4)

    def evset():
        return EvaluatorSet([_Entry("instance", COCOEvaluator(records)),
                             _Entry("semantic", SemSegEvaluator(3))])

    sets = [evset() for _ in range(3)]
    for i, (img, scores, classes, masks) in enumerate(preds):
        out = {"instance": (scores, classes, np.stack(masks))}
        rec = {"image_id": img}
        for s in (sets[i % 2], sets[2]):
            s.process(rec, out)
            s.entries[1].evaluator.process(np.full((4, 4), i % 3), np.full((4, 4), 1))
    sets[0].merge_from(sets[1])
    _equal(sets[0].evaluate(), sets[2].evaluate())
    with pytest.raises(ValueError, match="built from the same config"):
        sets[0].merge_from(EvaluatorSet([_Entry("instance", COCOEvaluator(records))]))


def _blocks(make, steps=2):
    """`steps` batches of the one-process loader `make(0, 1)` and of the two
    ranks' loaders `make(r, 2)`, with the slot axes padded alike."""
    from mp_former_tpu_torch.engine.train_step import pad_slots

    out = []
    for rank, world in ((0, 1), (0, 2), (1, 2)):
        loader = make(rank, world)
        try:
            out.append([next(loader) for _ in range(steps)])
        finally:
            loader.close(timeout=5.0)
    for whole, first, second in zip(*out):
        n = whole.targets.num_instances
        first, second = pad_slots(first, n), pad_slots(second, n)
        torch.testing.assert_close(torch.cat([first.images, second.images]), whole.images,
                                   rtol=0, atol=0)
        for a, b, c in zip(first.targets, second.targets, whole.targets):
            torch.testing.assert_close(torch.cat([a, b]), c, rtol=0, atol=0)
    return out


def test_loader_rank_blocks_make_the_one_process_batch(tmp_path):
    """Rank r of 2 yields rows [2r, 2r + 2) of the one-process batch of 4,
    with the same augmentation draws, for the LSJ mapper, a MaskFormer
    mapper (ADE20K semantic, multi-scale with a crop: batches fill by canvas
    shape) and the clip loader (whose slot axis the step pads)."""
    from mp_former_tpu_torch.config import build_cfg
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.data.dataset_mappers.coco_instance_new_baseline import \
        COCOInstanceNewBaselineDatasetMapper
    from mp_former_tpu_torch.data.dataset_mappers.mask_former_mappers import \
        MaskFormerSemanticDatasetMapper
    from mp_former_tpu_torch.data.datasets.register_all import register_all
    from mp_former_tpu_torch.data.datasets.coco import load_coco_json
    from mp_former_tpu_torch.data.loader import TrainLoader
    from mp_former_tpu_torch.video.ytvis import build_clip_loader, load_ytvis_json
    from tools.make_synthetic_coco_torch import write_dataset as write_coco
    from tools.make_synthetic_segm_torch import write_dataset as write_segm
    from tools.make_synthetic_ytvis_torch import write_dataset as write_ytvis

    root = str(tmp_path)
    json_file = write_coco(root, images=6, size=48, classes=3, split="train2017", seed=0)
    records = load_coco_json(json_file, os.path.join(root, "coco", "train2017"))
    cfg = build_cfg("configs/coco/instance-segmentation/maskformer2_R50_bs16_50ep.yaml",
                    ["INPUT.IMAGE_SIZE", "32", "TPU.MAX_INSTANCES", "6"])
    lsj = COCOInstanceNewBaselineDatasetMapper(cfg, is_train=True, max_instances=6)
    blocks = _blocks(lambda r, w: TrainLoader(records, lsj, 4, seed=3, num_workers=2,
                                              rank=r, world_size=w))
    assert blocks[1][0].images.shape == (2, 32, 32, 3)

    write_segm(root, "ade20k", "train", 6, 64, 96, 0)
    with mock.patch.object(DatasetCatalog, "_registry", {}):
        register_all(root)
        segm = DatasetCatalog.get("ade20k_sem_seg_train")
    cfg = build_cfg("configs/ade20k/semantic-segmentation/maskformer2_R50_bs16_160k.yaml", [
        "INPUT.MIN_SIZE_TRAIN", "(64, 80, 96)", "INPUT.MAX_SIZE_TRAIN", "256",
        "INPUT.CROP.SIZE", "(48, 64)", "INPUT.COLOR_AUG_SSD", "True"])
    sem = MaskFormerSemanticDatasetMapper(cfg, True, 20)
    _blocks(lambda r, w: TrainLoader(segm, sem, 4, seed=1, num_workers=2, rank=r,
                                     world_size=w))

    vjson = write_ytvis(root, videos=4, frames=(3,), height=48, width=64, classes=4,
                        split="train", seed=2)
    clips = load_ytvis_json(vjson, os.path.join(root, "ytvis_2019", "train", "JPEGImages"))
    cfg = build_cfg("configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml", [
        "INPUT.MIN_SIZE_TRAIN", "(32, 48)", "INPUT.MAX_SIZE_TRAIN", "64",
        "SOLVER.IMS_PER_BATCH", "4", "DATALOADER.NUM_WORKERS", "2"], video=True)
    _blocks(lambda r, w: build_clip_loader(cfg, clips, rank=r, world_size=w))
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        TrainLoader(records, lsj, 4, rank=0, world_size=3)
