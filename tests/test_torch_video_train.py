"""Video training in the port against the JAX package, at a small size: the
clip mappers, the tube matcher and losses, the slot cut of the clip collate,
one training step, and the video entry point training, resuming and scoring
on a synthetic dataset.

The JAX mappers read frames with cv2, so the tests write `.png` twins of the
`.npy` frames the port reads. Targets must agree exactly and frames within a
grey level (`tests/test_torch_data.py`'s rule). The random streams differ:
the tests record `jax.random.uniform` inside the JAX criterion and hand the
port the same numbers (`tests/test_torch_criterion.py:_run_both`), and the
step takes the JAX package's own assignments. Tolerances are those of
`tests/test_torch_criterion.py` and `tests/test_torch_train_step.py`.
"""

import copy
import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
from mp_former_tpu.models.matcher import _lsa_host
from mp_former_tpu.video import VideoTargets as JVideoTargets
from mp_former_tpu.video import criterion as jax_vcrit
from mp_former_tpu.video import ytvis as jax_ytvis

from mp_former_tpu_torch.data.catalog import DatasetCatalog
from mp_former_tpu_torch.engine.convert import named_gradients_from_jax
from mp_former_tpu_torch.engine.optimizer import build_gradient_clipper, build_optimizer
from mp_former_tpu_torch.engine.train_step import train_step
from mp_former_tpu_torch.models import criterion as tcrit_module
from mp_former_tpu_torch.structures import Batch, VideoTargets
from mp_former_tpu_torch.video import ytvis
from mp_former_tpu_torch.video.criterion import (VideoHungarianMatcher, VideoSetCriterion,
                                                 build_video_criterion)

from test_torch_criterion import RTOL, ATOL, _run_both
from test_torch_data import GREY_LEVELS
from test_torch_eval import _fractional_polygon
from test_torch_train_step import LR, check_parameters
from test_torch_video import SMALL, build_video_pair, video_cfgs
from tools.make_synthetic_ytvis_torch import write_dataset

torch.set_num_threads(2)

R50 = "configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml"
TRAIN_SIZES = ["INPUT.MIN_SIZE_TRAIN", "(48, 64)", "INPUT.MAX_SIZE_TRAIN", "96"]
K = 6  # classes of the criterion cases


def _png_twins(json_file, image_root, png_root):
    """`.png` copies of the split's `.npy` frames, for the JAX package."""
    with open(json_file) as f:
        for v in json.load(f)["videos"]:
            for name in v["file_names"]:
                stem = os.path.splitext(name)[0]
                os.makedirs(os.path.dirname(os.path.join(png_root, stem)), exist_ok=True)
                cv2.imwrite(os.path.join(png_root, stem + ".png"),
                            np.load(os.path.join(image_root, stem + ".npy")))


@pytest.fixture(scope="module")
def clip_records(tmp_path_factory):
    """Videos of 1, 2 and 5 frames, landscape (64x96) and portrait (96x64),
    from the port's tool (polygons and compressed RLE, objects absent from
    some frames), as (JAX records reading `.png`, port records reading
    `.npy`). The first 5-frame video gets an object present in its first
    frame only, put second among its annotations, and a crowd one."""
    root = str(tmp_path_factory.mktemp("ytvis_train"))
    jax_records, port_records = [], []
    for split, (h, w), seed in (("train", (64, 96), 0), ("tall", (96, 64), 1)):
        json_file = write_dataset(root, videos=4, frames=(1, 2, 5), height=h, width=w,
                                  classes=5, split=split, seed=seed)
        image_root = os.path.join(root, "ytvis_2019", split, "JPEGImages")
        png_root = os.path.join(root, "png", split)
        _png_twins(json_file, image_root, png_root)
        port_records += ytvis.load_ytvis_json(json_file, image_root)
        for r in jax_ytvis.load_ytvis_json(json_file, png_root):
            r["file_names"] = [os.path.splitext(f)[0] + ".png" for f in r["file_names"]]
            jax_records.append(r)
    five = next(i for i, r in enumerate(port_records) if r["length"] == 5)
    rng = np.random.RandomState(2)
    first_only = [_fractional_polygon(rng, 64, 96)]
    extra = [{"id": 900, "category_id": 3, "iscrowd": 0, "areas": None,
              "segmentations": [[first_only]] + [None] * 4},
             {"id": 901, "category_id": 1, "iscrowd": 1, "areas": None,
              "segmentations": [[first_only]] * 5}]
    for recs in (jax_records, port_records):
        annos = recs[five]["annotations"]
        recs[five]["annotations"] = annos[:1] + copy.deepcopy(extra) + annos[1:]
    return jax_records, port_records


@pytest.mark.parametrize("frames,shuffle", [(2, False), (3, True)])
def test_clip_mapper_matches_jax(monkeypatch, clip_records, frames, shuffle):
    """`YTVISDatasetMapper` against the JAX mapper on the same record and
    `RandomState`: labels, valid and masks equal, frames within a grey level,
    over flipped and unflipped clips, both short sides, landscape and
    portrait canvases, a video of one frame, and a slot left invalid between
    valid ones by an object absent from the sampled frames."""
    overrides = SMALL + TRAIN_SIZES + ["INPUT.SAMPLING_FRAME_RANGE", "1",
                                       "INPUT.SAMPLING_FRAME_SHUFFLE", str(shuffle)]
    jcfg, tcfg = video_cfgs(overrides=overrides, frames=frames)
    theirs = jax_ytvis.YTVISDatasetMapper(jcfg, max_instances=4)
    ours = ytvis.YTVISDatasetMapper(tcfg, max_instances=4)
    drawn, resize = [], ytvis.resize_shortest_edge
    monkeypatch.setattr(ytvis, "resize_shortest_edge",
                        lambda *a, **k: drawn.append(resize(*a, **k)) or drawn[-1])
    seen = set()
    for seed in range(6):
        for jrec, prec in zip(*clip_records):
            want = theirs(jrec, np.random.RandomState(seed))
            got = ours(prec, np.random.RandomState(seed))
            canvas = (64, 96) if prec["width"] >= prec["height"] else (96, 64)
            assert got["masks"].shape == want["masks"].shape == (4, frames, *canvas)
            assert got["image"].shape == want["image"].shape == (frames, *canvas, 3)
            assert got["labels"].dtype == np.int64 and got["masks"].dtype == bool
            np.testing.assert_array_equal(got["labels"], want["labels"])
            np.testing.assert_array_equal(got["valid"], want["valid"])
            np.testing.assert_array_equal(got["masks"], want["masks"])
            assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() \
                <= GREY_LEVELS
            for key in ("video_id", "height", "width"):
                assert got[key] == want[key]
            v = got["valid"]
            if v.any() and not v[:int(v.sum())].all():
                seen.add("hole")
            seen.add("length 1" if prec["length"] == 1 else "longer")
            seen.add("portrait" if canvas[0] > canvas[1] else "landscape")
            seen |= {"flip" if drawn[-1].flip else "no flip",
                     f"short side {min(drawn[-1].out_h, drawn[-1].out_w)}"}
    assert seen == {"hole", "length 1", "longer", "portrait", "landscape", "flip", "no flip",
                    "short side 48", "short side 64"}
    assert ours(dict(clip_records[1][0], file_names=["missing.npy"]),
                np.random.RandomState(0)) is None


def test_coco_clip_mapper_matches_jax(tmp_path):
    """`CocoClipDatasetMapper`: a COCO image through the LSJ instance mapper,
    repeated into a clip, against the JAX mapper on the same record and
    seed (images of 40-90 px, polygon annotations)."""
    from mp_former_tpu.video.ytvis import CocoClipDatasetMapper as JaxCocoClip

    overrides = SMALL + ["INPUT.IMAGE_SIZE", "64"]
    jcfg, tcfg = video_cfgs(overrides=overrides, frames=3)
    theirs, ours = JaxCocoClip(jcfg, max_instances=4), ytvis.CocoClipDatasetMapper(
        tcfg, max_instances=4)
    rng = np.random.RandomState(5)
    for i in range(4):
        h, w = (int(x) for x in rng.randint(40, 91, 2))
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"{i}.png"), img)
        np.save(str(tmp_path / f"{i}.npy"), img)
        annos = [{"category_id": int(rng.randint(0, 40)), "iscrowd": 0,
                  "segmentation": [_fractional_polygon(rng, h, w)]} for _ in range(3)]
        base = {"image_id": i, "height": h, "width": w, "annotations": annos}
        want = theirs({**base, "file_name": str(tmp_path / f"{i}.png")}, np.random.RandomState(i))
        got = ours({**base, "file_name": str(tmp_path / f"{i}.npy")}, np.random.RandomState(i))
        assert set(got) == set(want)
        assert got["image"].shape == want["image"].shape == (3, 64, 64, 3)
        assert got["masks"].shape == want["masks"].shape and got["masks"].shape[:2] == (4, 3)
        for key in ("labels", "valid", "masks"):
            np.testing.assert_array_equal(got[key], want[key])
        assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= GREY_LEVELS
        assert (got["image"] == got["image"][:1]).all() and got["valid"].any()
        assert (got["video_id"], got["height"], got["width"]) == (i, h, w)


def _video_case(rng, b, q, n, t, h, w, layers, valid):
    """Outputs of `layers` decoder layers for clips of t frames, and their
    targets in both packages (tubes at 4x the prediction grid, empty where
    invalid)."""
    def layer():
        return {"pred_logits": rng.randn(b, q, K + 1).astype(np.float32),
                "pred_masks": (rng.randn(b, q, t, h, w) * 3).astype(np.float32)}

    outputs = layer()
    outputs["aux_outputs"] = [layer() for _ in range(layers - 1)]
    outputs["dn_out"] = None
    valid = np.asarray(valid, bool)
    masks = (rng.rand(b, n, t, 4 * h, 4 * w) > 0.6) & valid[:, :, None, None, None]
    labels = rng.randint(0, K, (b, n))
    jt = JVideoTargets(jnp.asarray(labels, jnp.int32), jnp.asarray(masks), jnp.asarray(valid))
    tt = VideoTargets(torch.from_numpy(labels), torch.from_numpy(masks), torch.from_numpy(valid))
    return outputs, jt, tt


def _criteria(max_pairs, num_points=32):
    args = dict(weight_dict={}, eos_coef=0.1, losses=["labels", "masks"], num_points=num_points,
                oversample_ratio=3.0, importance_sample_ratio=0.75, max_pairs=max_pairs,
                point_sample_mode="random")
    jc = jax_vcrit.VideoSetCriterion(
        K, jax_vcrit.VideoHungarianMatcher(2.0, 5.0, 5.0, num_points), point_matmul=False, **args)
    tc = VideoSetCriterion(K, VideoHungarianMatcher(2.0, 5.0, 5.0, num_points), **args)
    return jc, tc


@pytest.mark.parametrize("max_pairs", [0, 3])
def test_video_matcher_and_losses_match_jax(monkeypatch, max_pairs):
    """The tube matcher's costs (one set of points shared by the frames, the
    ceiling on invalid columns, a hole among them) and the losses of every
    layer on the JAX package's recorded points, given external assignments:
    all (tube, frame) pairs, and 3 of 6, the overflow dropped in row-major
    order."""
    b, q, n, t, h, w, layers = 2, 7, 5, 2, 8, 12, 3
    rng = np.random.RandomState(max_pairs)
    valid = [[1, 0, 1, 0, 0], [0, 1, 0, 0, 0]]
    outputs, jt, tt = _video_case(rng, b, q, n, t, h, w, layers, valid)
    jc, tc = _criteria(max_pairs)

    key = jax.random.PRNGKey(4)
    want = np.asarray(jc.matcher.cost(jnp.asarray(outputs["pred_logits"]),
                                      jnp.asarray(outputs["pred_masks"]), jt, key))
    coords = torch.from_numpy(np.array(jax.random.uniform(key, (b, 32, 2))))
    got = tc.matcher.cost(torch.from_numpy(outputs["pred_logits"]),
                          torch.from_numpy(outputs["pred_masks"]), tt, coords=coords).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    v = np.asarray(valid, bool)
    for i in range(b):
        np.testing.assert_allclose(got[i][:, ~v[i]], got[i][:, v[i]].max() + 1.0, rtol=1e-6)

    assignments = np.stack([np.stack([rng.permutation(q)[:n] for _ in range(b)])
                            for _ in range(layers)]).astype(np.int64)
    losses = _run_both(monkeypatch, jc, tc, outputs, jt, tt, assignments)
    assert len(losses) == 6 * layers and all(
        losses[k].item() == 0.0 for k in losses if "_dn" in k)
    assert all(losses[k].item() > 0 for k in losses if "_dn" not in k)


def test_slot_cut_changes_no_loss():
    """`collate_clips` cuts the slot axis after the batch's last valid slot,
    keeping the invalid slots between valid ones: the port's criterion, its
    own matcher included, gives the same losses on the cut batch as on the
    batch of all slots, with the same draws."""
    b, q, n, t, h, w, layers = 2, 7, 8, 2, 8, 12, 3
    rng = np.random.RandomState(9)
    valid = [[1, 0, 1, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 0, 0]]
    outputs, _, full = _video_case(rng, b, q, n, t, h, w, layers, valid)
    samples = [{"image": np.zeros((t, 4 * h, 4 * w, 3), np.uint8),
                **{k: getattr(full, k)[i].numpy() for k in ("labels", "masks", "valid")}}
               for i in range(b)]
    cut = ytvis.collate_clips(samples).targets
    assert cut.masks.shape == (b, 3, t, 4 * h, 4 * w) and cut.labels.dtype == torch.int64
    assert cut.valid.tolist() == [[True, False, True], [False, True, False]]
    _, tc = _criteria(0)
    outputs = {k: v for k, v in outputs.items() if k != "dn_out"}
    to_torch = {"pred_logits": torch.from_numpy, "pred_masks": torch.from_numpy}
    outputs = {k: [{kk: to_torch[kk](vv) for kk, vv in o.items()} for o in v]
               if k == "aux_outputs" else to_torch[k](v) for k, v in outputs.items()}
    got = tc(outputs, cut, torch.Generator().manual_seed(0))
    want = tc(outputs, full, torch.Generator().manual_seed(0))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7, msg=k)
    empty = ytvis.collate_clips([{**s, "valid": np.zeros(n, bool)} for s in samples]).targets
    assert empty.valid.shape == (b, 1) and not empty.valid.any()


STEP = SMALL + ["MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "SOLVER.BASE_LR", str(LR),
                "SOLVER.CLIP_GRADIENTS.ENABLED", "False", "SOLVER.LR_SCHEDULER_NAME",
                "WarmupMultiStepLR", "MODEL.BACKBONE.FREEZE_AT", "2"]


def test_video_step_matches_jax(monkeypatch):
    """One training step at T = 2 in both packages, on two clips with a slot
    left invalid between valid ones: the loss dict (the JAX package's own
    assignments, the loss points recorded in the JAX criterion and replayed),
    every gradient, and the parameters after AdamW, at
    `tests/test_torch_train_step.py`'s tolerances. The encoder's sampling
    offsets keep the reference init (weights 0, the compass rose's bias), so
    every sampling location is a pixel centre of its own level, where the
    derivative in the location jumps (levels 12, 6 and 3 wide)."""
    jcfg, jmodel, params, tcfg, tmodel = build_video_pair(frames=2, seed=2, overrides=STEP,
                                                          at_init=("sampling_offsets",))
    rng = np.random.RandomState(6)
    clips = rng.randint(0, 256, (2, 2, 64, 96, 3)).astype(np.uint8)
    valid = np.asarray([[1, 0, 1, 0], [1, 1, 0, 0]], bool)
    masks = np.zeros((2, 4, 2, 64, 96), bool)
    for i, j in zip(*np.nonzero(valid)):
        y, x = rng.randint(0, 32), rng.randint(0, 48)
        masks[i, j, :, y:y + 24, x:x + 40] = True
        masks[i, j, 1] = np.roll(masks[i, j, 1], 4, axis=1)
    labels = rng.randint(0, 40, (2, 4))
    jt = JVideoTargets(jnp.asarray(labels, jnp.int32), jnp.asarray(masks), jnp.asarray(valid))
    tt = VideoTargets(torch.from_numpy(labels), torch.from_numpy(masks), torch.from_numpy(valid))
    jcrit = jax_vcrit.build_video_criterion(jcfg)
    jcrit.point_matmul = False
    rng_loss = jax.random.PRNGKey(3)
    num_masks = jnp.maximum(jt.valid.sum().astype(jnp.float32), 1.0)
    images = jnp.asarray(clips)

    @jax.jit
    def cost_pass(p):
        out = jmodel.apply({"params": p}, images, None, train=True)
        return jcrit.layer_costs(out, jt, rng_loss)[0]

    costs = np.asarray(cost_pass(params))
    l, b, q, n = costs.shape
    assignments = _lsa_host(costs.reshape(l * b, q, n)).reshape(l, b, n)

    recorded, real_uniform = [], jax.random.uniform

    def loss_fn(p):
        out = jmodel.apply({"params": p}, images, None, train=True)
        monkeypatch.setattr(jax.random, "uniform", recording)
        losses = jcrit(out, jt, rng_loss, num_masks=num_masks,
                       assignments=jnp.asarray(assignments))
        monkeypatch.setattr(jax.random, "uniform", real_uniform)
        return jcrit.weighted_total(losses), (losses, list(recorded))

    def recording(*args, **kwargs):
        recorded.append(real_uniform(*args, **kwargs))
        return recorded[-1]

    (jtotal, (jlosses, draws)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    draws = [np.asarray(d) for d in draws]
    assert len(draws) == 2
    tx = jax_build_optimizer(jcfg, params)
    jnew = jax.jit(lambda g, p: jax.tree.map(
        lambda a, u: a + u, p, tx.update(g, tx.init(p), p)[0]))(jgrads, params)

    def replayed_uniform(shape, generator, device):
        rec = draws.pop(0)
        return torch.from_numpy(rec[tuple(slice(0, s) for s in shape)].copy())

    monkeypatch.setattr(tcrit_module, "uniform", replayed_uniform)
    model = copy.deepcopy(tmodel)
    optimizer, scheduler = build_optimizer(tcfg, model)
    criterion = build_video_criterion(tcfg)
    criterion.assign = lambda c: torch.from_numpy(assignments.astype(np.int64))
    metrics = train_step(model, criterion, optimizer, scheduler,
                         Batch(torch.from_numpy(clips), tt), torch.Generator().manual_seed(0),
                         clip_gradients=build_gradient_clipper(tcfg))
    assert not draws, "the port drew fewer times than the JAX criterion"

    want = {k: float(v) for k, v in jlosses.items()}
    assert set(metrics) == set(want) | {"total_loss"} and len(want) == 6 * 4
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(metrics["total_loss"].item(), float(jtotal), rtol=1e-4)

    jgrads = jax.tree.map(np.asarray, jgrads)
    grads = named_gradients_from_jax(jgrads, model)
    largest = max(g.abs().max().item() for g in grads.values())
    names = []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and name.startswith(("backbone.stem", "backbone.res2")), name
            continue
        scale = max(grads[name].abs().max().item(), 1e-4 * largest)
        assert (p.grad - grads[name]).abs().max().item() <= 1e-3 * scale, name
        names.append(name)
    for part in ("backbone.res5", "encoder.layers.0.self_attn.sampling_offsets",
                 "multihead_attn.in_proj_weight", "query_embed", "query_feat", "mask_embed"):
        assert any(part in x for x in names), part
    check_parameters({"model": model, "start": tmodel, "jgrads": jgrads,
                      "jnew": jax.tree.map(np.asarray, jnew)})


def test_video_entry_point_trains_resumes_and_scores(tmp_path, monkeypatch):
    """`python -m mp_former_tpu_torch.train_net_video` without --eval-only
    on a synthetic split of `.npy` frames: 2 steps with `Trainer.test`
    scoring tube AP after the second, `metrics.json` and a checkpoint; then
    `--resume` continues to step 3 from the checkpoint, and `--eval-only
    --resume` scores the last checkpoint."""
    from mp_former_tpu_torch import train_net_video
    from mp_former_tpu_torch.engine.trainer import Trainer

    root = tmp_path / "data"
    write_dataset(str(root), videos=3, frames=(2, 3, 1), height=64, width=96, classes=40,
                  split="train", seed=0)
    write_dataset(str(root), videos=2, frames=(2, 3), height=64, width=96, classes=40,
                  split="valid", seed=1)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(root))
    fresh = type(DatasetCatalog)()
    monkeypatch.setattr(ytvis, "DatasetCatalog", fresh)
    monkeypatch.setattr("mp_former_tpu_torch.data.catalog.DatasetCatalog", fresh)
    scored, test = [], Trainer.test

    def recording_test(self, *args, **kwargs):
        scored.append(test(self, *args, **kwargs))
        return scored[-1]

    monkeypatch.setattr(Trainer, "test", recording_test)
    out = str(tmp_path / "out")
    parse = train_net_video.default_argument_parser().parse_args
    flags = ["--config-file", R50]
    keys = SMALL + TRAIN_SIZES + [
        "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "TPU.MAX_INSTANCES", "10",
        "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "1", "TEST.EVAL_PERIOD", "2",
        "MODEL.DEVICE", "cpu", "OUTPUT_DIR", out]
    assert train_net_video.main(parse(flags + keys + ["SOLVER.MAX_ITER", "2"])) is None
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["iteration"] for x in lines] == [0, 1]
    assert all(np.isfinite(v) for x in lines for v in x.values())
    assert len([k for k in lines[-1] if k.startswith("loss_")]) == 6 * 4
    ckpt = os.path.join(out, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["last_checkpoint", "model_0000002.pth"]
    assert len(scored) == 1 and set(scored[0]["segm"]) == {"AP", "AP50", "AP75", "APs", "APm",
                                                           "APl"}
    assert np.isfinite(scored[0]["segm"]["AP"])

    train_net_video.main(parse(flags + ["--resume"] + keys + ["SOLVER.MAX_ITER", "3"]))
    with open(os.path.join(out, "metrics.json")) as f:
        assert [json.loads(x)["iteration"] for x in f] == [0, 1, 2]
    assert "model_0000003.pth" in os.listdir(ckpt)
    results = train_net_video.main(parse(flags + ["--eval-only", "--resume"] + keys))
    assert np.isfinite(results["segm"]["AP"])
    assert fresh.list() == ["ytvis_2019_train", "ytvis_2019_val", "ytvis_2021_train",
                            "ytvis_2021_val"]
