"""The port's video evaluation against the JAX package's: the YouTube-VIS
segmentation decoders, the records, the tube evaluator on the same
predictions, `inference_video`, and the whole-clip loop on videos of
2, 3, 5 and 16 frames of different sizes; then the video entry point on a
dataset written by `tools/make_synthetic_ytvis_torch.py`.

The port reads frames as BGR `.npy`; the JAX package decodes images with
cv2, so the tests write `.png` twins of the same pixels for it.
"""

import json
import os
from unittest import mock

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mp_former_tpu.video.eval_loop as jax_eval_loop
from mp_former_tpu.utils.interp import resize as jax_resize
from mp_former_tpu.video import ytvis as jax_ytvis
from mp_former_tpu.video.ytvis_eval import YTVISEvaluator as JaxYTVISEvaluator

from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from mp_former_tpu_torch.video import ytvis
from mp_former_tpu_torch.video.eval_loop import (inference_on_video_dataset, inference_video,
                                                 prep_clip)
from mp_former_tpu_torch.video.ytvis_eval import YTVISEvaluator

from test_torch_video import SMALL, build_video_pair
from tools.make_synthetic_ytvis_torch import rle_string, write_dataset

torch.set_num_threads(2)

R50 = "configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml"


def _plain_counts(mask):
    """Uncompressed COCO RLE counts of a (h, w) bool mask."""
    flat = mask.T.reshape(-1)
    counts, val, run = [], False, 0
    for v in flat:
        if v == val:
            run += 1
        else:
            counts.append(run)
            val, run = v, 1
    counts.append(run)
    return counts


def test_segmentations_decode_as_in_jax():
    """Compressed RLE (the tool's encoder, pycocotools' rleToString), plain
    RLE counts, polygons and absent frames, decoded by both packages."""
    rng = np.random.RandomState(0)
    h, w = 23, 31
    for density in (0.0, 0.4, 1.0):
        m = rng.rand(h, w) < density
        m[0, 0] = density > 0.5  # a run of 0 background first, or none
        seg = rle_string(m)
        assert ytvis._decode_compressed_counts(seg["counts"]) \
            == jax_ytvis._decode_compressed_counts(seg["counts"]) \
            == jax_ytvis._decode_compressed_counts(seg["counts"].encode())
        for s in (seg, {"size": [h, w], "counts": _plain_counts(m)}):
            got = ytvis._seg_to_mask(s, h, w)
            np.testing.assert_array_equal(got, m)
            np.testing.assert_array_equal(got, jax_ytvis._seg_to_mask(s, h, w))
    polys = [[2.5, 3, 20, 4.25, 11, 19.5], [25, 1, 30, 1, 30, 22, 25, 22], [1, 1, 2, 2]]
    got = ytvis._seg_to_mask(polys, h, w)
    assert got.any()
    np.testing.assert_array_equal(got, jax_ytvis._seg_to_mask(polys, h, w))
    assert ytvis._seg_to_mask(None, h, w) is None is jax_ytvis._seg_to_mask(None, h, w)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A YouTube-VIS validation split of 4 videos of 2-4 frames (96x128), as
    the port's tool writes it, and `.png` twins of its frames for the JAX
    package."""
    root = str(tmp_path_factory.mktemp("ytvis"))
    json_file = write_dataset(root, videos=4, frames=(2, 3, 4), height=96, width=128,
                              classes=5, split="valid", seed=3)
    image_root = os.path.join(root, "ytvis_2019", "valid", "JPEGImages")
    png_root = os.path.join(root, "png")
    with open(json_file) as f:
        for v in json.load(f)["videos"]:
            for name in v["file_names"]:
                stem = os.path.splitext(name)[0]
                os.makedirs(os.path.dirname(os.path.join(png_root, stem)), exist_ok=True)
                cv2.imwrite(os.path.join(png_root, stem + ".png"),
                            np.load(os.path.join(image_root, stem + ".npy")))
    return root, json_file, image_root, png_root


def _jax_records(json_file, png_root):
    recs = jax_ytvis.load_ytvis_json(json_file, png_root)
    for r in recs:
        r["file_names"] = [os.path.splitext(f)[0] + ".png" for f in r["file_names"]]
    return recs


def test_records_and_registrations_match_jax(synth):
    root, json_file, image_root, png_root = synth
    got = ytvis.load_ytvis_json(json_file, image_root, "synth_ytvis_records")
    want = jax_ytvis.load_ytvis_json(json_file, image_root)
    assert len(got) == 4 and sum(len(r["annotations"]) for r in got) > 4
    kinds = {type(s).__name__ for r in got for a in r["annotations"]
             for s in a["segmentations"]}
    assert {"list", "dict"} <= kinds  # polygons and compressed RLE
    for g, w in zip(got, want):
        assert g["file_names"] == [os.path.splitext(f)[0] + ".npy" for f in w["file_names"]]
        assert all(os.path.isfile(f) for f in g["file_names"])
        assert {k: v for k, v in g.items() if k != "file_names"} \
            == {k: v for k, v in w.items() if k != "file_names"}
    meta = MetadataCatalog.get("synth_ytvis_records")
    assert meta.thing_classes == [f"shape_{c}" for c in range(5)]
    assert meta.thing_dataset_id_to_contiguous_id == {c + 1: c for c in range(5)}
    fresh = type(DatasetCatalog)()
    with mock.patch.object(ytvis, "DatasetCatalog", fresh):
        ytvis.register_all_ytvis(root)
        assert fresh.list() == ["ytvis_2019_train", "ytvis_2019_val", "ytvis_2021_train",
                                "ytvis_2021_val"]
        assert [r["video_id"] for r in fresh.get("ytvis_2019_val")] == [1, 2, 3, 4]
    assert MetadataCatalog.get("ytvis_2019_val").evaluator_type == "ytvis"


def _tube_predictions(rec, rng):
    """Predictions for one record: each ground-truth tube shifted by a few
    pixels in some frames (a class of its own or another), and a blob that
    matches nothing; random scores."""
    h, w, t = rec["height"], rec["width"], rec["length"]
    scores, classes, tubes = [], [], []
    for a in rec["annotations"]:
        tube = np.zeros((t, h, w), bool)
        for fi, seg in enumerate(a["segmentations"]):
            m = ytvis._seg_to_mask(seg, h, w)
            if m is not None:
                tube[fi] = np.roll(m, rng.randint(-3, 4), axis=rng.randint(2))
        scores.append(rng.rand())
        classes.append(a["category_id"] if rng.rand() < 0.8 else rng.randint(5))
        tubes.append(tube)
    blob = np.zeros((t, h, w), bool)
    blob[:, 10:40, 20:60] = True
    return np.asarray(scores + [rng.rand()]), np.asarray(classes + [0]), tubes + [blob]


def test_ytvis_evaluator_matches_jax(synth):
    _, json_file, image_root, png_root = synth
    records = ytvis.load_ytvis_json(json_file, image_root)
    got, want = YTVISEvaluator(records), JaxYTVISEvaluator(_jax_records(json_file, png_root))
    rng = np.random.RandomState(4)
    for rec in records:
        scores, classes, tubes = _tube_predictions(rec, rng)
        got.process(rec["video_id"], scores, classes, tubes)
        want.process(rec["video_id"], scores, classes, tubes)
    g, w = got.evaluate()["segm"], want.evaluate()["segm"]
    assert g.keys() == w.keys() and 0 < g["AP"] < 100
    for k in g:
        assert (np.isnan(g[k]) and np.isnan(w[k])) or abs(g[k] - w[k]) <= 1e-9, k


def test_inference_video_matches_jax():
    """Top-k over Q x K float64 scores, then the chosen masks upsampled x4,
    cropped and resized: the tubes agree wherever the JAX package's resized
    logits are not within 1e-5 of 0."""
    rng = np.random.RandomState(5)
    q, k, t = 8, 5, 3
    logits = rng.randn(q, k + 1).astype(np.float32)
    masks = rng.randn(q, t, 16, 24).astype(np.float32)
    img_size, out_h, out_w = (60, 90), 45, 70
    scores, classes, tubes = inference_video(torch.from_numpy(logits), torch.from_numpy(masks),
                                             img_size, out_h, out_w, k)
    w_scores, w_classes, w_tubes = jax_eval_loop.inference_video(
        logits, jnp.asarray(masks), img_size, out_h, out_w, k)
    np.testing.assert_allclose(scores, w_scores, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(classes, w_classes)
    assert tubes.shape == w_tubes.shape == (10, t, out_h, out_w) and tubes.dtype == bool
    top = np.argsort(-_softmax64(logits)[:, :-1].ravel())[:10]
    floats = jax_resize(jax_resize(jnp.asarray(masks[top // k]), (64, 96), "bilinear")
                        [:, :, :60, :90], (out_h, out_w), "bilinear")
    clear = np.abs(np.asarray(floats)) > 1e-5
    assert np.array_equal(tubes[clear], w_tubes[clear]) and clear.mean() > 0.99


def _softmax64(x):
    e = np.exp(x.astype(np.float64) - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# (frames, height, width): 2, 3 and 16 frames run unpadded in the JAX loop,
# 5 is padded to its length bucket of 8; 96x64 and 64x96 need no resize at
# MIN_SIZE_TEST 64, 80x80 and 48x72 are resized (down, up)
LOOP_VIDEOS = [(2, 64, 96), (3, 96, 64), (5, 80, 80), (16, 48, 72)]


def _write_clips(root, rng):
    """Each video of LOOP_VIDEOS as `.npy` frames for the port and `.png`
    twins for the JAX package: noise with two coloured boxes that move."""
    port, jax_recs = [], []
    for vi, (t, h, w) in enumerate(LOOP_VIDEOS):
        names = []
        for fi in range(t):
            img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            img[8 + fi:30 + fi, 10:40] = (250, 10, 10)
            img[h - 30:h - 8, w - 40 - fi:w - 12 - fi] = (10, 200, 40)
            stem = os.path.join(root, f"v{vi}_{fi:02d}")
            np.save(stem + ".npy", img)
            cv2.imwrite(stem + ".png", img)
            names.append(stem)
        rec = {"video_id": vi + 1, "height": h, "width": w, "length": t, "annotations": []}
        port.append(dict(rec, file_names=[n + ".npy" for n in names]))
        jax_recs.append(dict(rec, file_names=[n + ".png" for n in names]))
    return port, jax_recs


def _ground_truth_from(tubes, classes, ranks=(1, 3, 4)):
    """Annotations from the tubes at `ranks` of one clip's top-k (compressed
    RLE, plain RLE counts, compressed RLE): higher-scored predictions match
    no annotation, so the AP is below 100 and moves with the ranking."""
    annos = []
    for j, r in enumerate(ranks):
        segs = [rle_string(m) if j != 1 else {"size": list(m.shape), "counts": _plain_counts(m)}
                for m in tubes[r]]
        annos.append({"id": j + 1, "category_id": int(classes[r]), "iscrowd": 0,
                      "segmentations": segs, "areas": [float(m.sum()) for m in tubes[r]]})
    return annos


def _blocked_rows(tmodel, clip):
    """Query rows that some cross-attention layer sees blocked on every key
    of the clip, in a forward through the port (the rows that the all-blocked
    reset opens to every key)."""
    decoder = tmodel.sem_seg_head.predictor
    heads, seen = decoder.forward_prediction_heads, []

    def recording(*args):
        out = heads(*args)
        seen.append(int(out[2].all(-1).sum()))
        return out

    with mock.patch.object(decoder, "forward_prediction_heads", recording), torch.no_grad():
        tmodel(clip)
    return seen[:decoder.num_layers]  # the last heads' mask enters no layer


def test_whole_clip_loop_matches_jax(tmp_path):
    """Each video of LOOP_VIDEOS through the port's whole-clip loop and the
    JAX package's, as a dataset of its own, with ground truth from the port's
    own top tubes: the canvases agree within one grey level (cv2 against
    `_resize_image`, exactly without a resize), and tube AP within 1e-6 of
    the JAX loop run unpadded (`t_bucket` the identity). The JAX loop as it
    is pads 5 frames to 8: its AP there may differ only where a query row is
    blocked on every real key, which the reference's reset reopens to the
    padding frames too (`mp_former_tpu/video/video_decoder.py:96-99`)."""
    jcfg, jmodel, params, tcfg, tmodel = build_video_pair(frames=2, seed=6)
    port_recs, jax_recs = _write_clips(str(tmp_path), np.random.RandomState(7))
    num_classes = tcfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    jax_eval_loop._CLIP_FWD_CACHE.clear()
    for (t, h, w), prec, jrec in zip(LOOP_VIDEOS, port_recs, jax_recs):
        item, jitem = prep_clip(tcfg, prec), jax_eval_loop.prep_clip(jcfg, jrec)
        assert (item["rh"], item["rw"]) == (jitem["rh"], jitem["rw"])
        canvas_err = np.abs(item["clip"] - jitem["clip"][:t]).max()
        assert canvas_err <= (0 if (h, w) in ((64, 96), (96, 64)) else 1), (t, canvas_err)
        clip = torch.from_numpy(item["clip"])[None]
        with torch.no_grad():
            out = tmodel(clip)
        _, classes, tubes = inference_video(out["pred_logits"][0], out["pred_masks"][0],
                                            (item["rh"], item["rw"]), h, w, num_classes)
        annos = _ground_truth_from(tubes, classes)
        prec["annotations"] = jrec["annotations"] = annos
        got = inference_on_video_dataset(tcfg, tmodel, [prec])["segm"]
        with mock.patch.object(jax_eval_loop, "t_bucket", lambda n: n):
            unpadded = jax_eval_loop.inference_on_video_dataset(
                jcfg, jmodel, {"params": params}, [jrec])["segm"]
        assert 0 < got["AP"] < 100, (t, got)
        for k in got:
            assert (np.isnan(got[k]) and np.isnan(unpadded[k])) \
                or abs(got[k] - unpadded[k]) <= 1e-6, (t, k, got[k], unpadded[k])
        if jax_eval_loop.t_bucket(t) == t:
            continue
        padded = jax_eval_loop.inference_on_video_dataset(
            jcfg, jmodel, {"params": params}, [jrec])["segm"]
        if abs(padded["AP"] - got["AP"]) > 1e-6:
            blocked = _blocked_rows(tmodel, clip)
            assert sum(blocked) > 0, (
                f"{t} frames: the JAX loop padded to {jax_eval_loop.t_bucket(t)} gives AP "
                f"{padded['AP']} against {got['AP']} with no query row blocked on every key")
            print(f"{t} frames, padded to {jax_eval_loop.t_bucket(t)} by the JAX loop: AP "
                  f"{padded['AP']:.4f} against {got['AP']:.4f} unpadded; rows blocked on every "
                  f"real key, by layer: {blocked}")


def test_video_entry_point_scores_a_synthetic_dataset(tmp_path, monkeypatch):
    """`python -m mp_former_tpu_torch.train_net_video --eval-only` on a dataset
    of `.npy` frames from `tools/make_synthetic_ytvis_torch.py`, registered
    from $DETECTRON2_DATASETS as `ytvis_2019_val`: tube AP printed; the
    weights come from MODEL.WEIGHTS, or are refused where there are none."""
    from mp_former_tpu_torch import train_net_video
    from mp_former_tpu_torch.models import build_model

    root = tmp_path / "data"
    write_dataset(str(root), videos=3, frames=(2, 3), height=64, width=96, classes=40,
                  split="valid", seed=1)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(root))
    fresh = type(DatasetCatalog)()
    monkeypatch.setattr(ytvis, "DatasetCatalog", fresh)
    monkeypatch.setattr("mp_former_tpu_torch.data.catalog.DatasetCatalog", fresh)
    out = str(tmp_path / "out")
    flags = ["--config-file", R50, "--eval-only"]
    keys = SMALL + ["MODEL.DEVICE", "cpu", "OUTPUT_DIR", out]
    with pytest.raises(ValueError, match="MODEL.WEIGHTS"):
        train_net_video.main(train_net_video.default_argument_parser().parse_args(flags + keys))
    cfg = train_net_video.setup(train_net_video.default_argument_parser().parse_args(
        flags + keys))
    weights = str(tmp_path / "model_final.pth")
    torch.save({"model": build_model(cfg).state_dict()}, weights)
    results = train_net_video.main(train_net_video.default_argument_parser().parse_args(
        flags + keys + ["MODEL.WEIGHTS", weights]))
    assert set(results["segm"]) == {"AP", "AP50", "AP75", "APs", "APm", "APl"}
    assert np.isfinite(results["segm"]["AP"])
    assert fresh.list() == ["ytvis_2019_train", "ytvis_2019_val", "ytvis_2021_train",
                            "ytvis_2021_val"]
