"""The port's demo, video-demo and predict entry points (ROADMAP A22) against
the JAX package's `demo/`, `demo_video/` and `predict.py`, with the small
model of `tests/test_torch_slice.py` and its weights carried across.

- `demo/predictor.py`: the raw forward against the JAX demo's on an image
  that needs no resize (logits within 1e-3, mask logits within 1e-2: the
  slice's limits); the drawings bit for bit with cv2 given the same
  predictions; `AsyncPredictor` in submit order.
- The image demo and `predict.py` end to end in this process, the JAX mains
  fed the port's raw forward: every written PNG equal bit for bit.
- The video demo: the whole-clip forward's top-10 tubes against the JAX
  demo's steps (scores within 1e-5, the same classes, tubes equal away from
  mask logits within 5e-2 of 0) and `TrackVisualizer` bit for bit.
- Each command line on `.npy` inputs in a subprocess in which jax, the JAX
  package, cv2 and PIL cannot be imported: it writes its PNGs, and the
  drawings without labels equal the in-process ones where no label lies.
"""

import importlib.util
import os
import subprocess
import sys
import textwrap
from unittest import mock

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine.eval_loop import (postprocess_instance as jax_postprocess_instance,
                                            postprocess_semantic as jax_postprocess_semantic)

from mp_former_tpu_torch.demo import overlay
from mp_former_tpu_torch.demo.predictor import AsyncPredictor, Predictor, VisualizationDemo

from test_torch_slice import SMALL, _build_pair
from test_torch_video import R50 as VIDEO_R50, SMALL as VIDEO_SMALL, build_video_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAN_CONFIG = "configs/coco/panoptic-segmentation/maskformer2_R50_bs16_50ep.yaml"
# SMALL on the panoptic recipe (133 classes, its vanilla decoder): every task on
PAN_SMALL = [*SMALL[2:], "MODEL.WEIGHTS", ""]
IMAGE_HW = (64, 96)  # MIN_SIZE_TEST 64, MAX_SIZE_TEST 96: no resize on either side
BLOCKED = ("jax", "jaxlib", "flax", "mp_former_tpu", "cv2", "PIL")


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pan(tmp_path_factory):
    """The panoptic recipe's small pair, its weights as a reference `.pth`,
    an image as `.npy` and `.png`, and the port's demo predictor on the CPU."""
    root = tmp_path_factory.mktemp("demo")
    jcfg, jmodel, params, tcfg, tmodel, _ = _build_pair(PAN_SMALL, IMAGE_HW, PAN_CONFIG)
    weights = str(root / "w.pth")
    torch.save({"model": tmodel.state_dict()}, weights)
    img = np.random.RandomState(5).randint(0, 256, (*IMAGE_HW, 3), dtype=np.uint8)
    np.save(root / "img.npy", img)
    cv2.imwrite(str(root / "img.png"), img)
    tcfg.defrost()
    tcfg.merge_from_list(["MODEL.WEIGHTS", weights])
    tcfg.freeze()
    port = Predictor(tcfg, device="cpu")
    return {"root": root, "jcfg": jcfg, "jmodel": jmodel, "params": params, "tcfg": tcfg,
            "port": port, "weights": weights, "img": img}


def test_demo_predictor_matches_jax(pan):
    jax_pred = _load("jax_demo_predictor", "demo/predictor.py")
    jp = jax_pred.Predictor(pan["jcfg"])
    jp.params = {"params": pan["params"]}  # the weights carried across, no init
    img = pan["img"]
    logits, masks, size = pan["port"].forward_raw(img)
    want_logits, want_masks, want_size = jp.forward_raw(img)
    assert size == tuple(want_size) == IMAGE_HW
    assert logits.shape == want_logits.shape == (8, 134) and masks.shape == want_masks.shape
    assert np.abs(logits - want_logits).max() < 1e-3
    assert np.abs(masks - want_masks).max() < 1e-2

    # the post-processings of both packages on the port's raw outputs
    got = pan["port"](img)
    assert set(got) == {"instances", "sem_seg"}
    k, topk = 133, pan["tcfg"].TEST.DETECTIONS_PER_IMAGE
    scores, classes, bin_masks = jax_postprocess_instance(logits, masks, size, *IMAGE_HW, k, topk)
    port_inst = got["instances"]
    np.testing.assert_allclose(port_inst["scores"], np.asarray(scores), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port_inst["classes"], np.asarray(classes))
    np.testing.assert_array_equal(port_inst["masks"], np.asarray(bin_masks))
    sem = np.asarray(jax_postprocess_semantic(logits, masks, size, *IMAGE_HW,
                                              before_inference=True))
    np.testing.assert_allclose(got["sem_seg"], sem, rtol=0, atol=1e-5)

    # the drawings, bit for bit with cv2, given the same predictions
    jax_cli = _load("jax_demo_cli", "demo/demo.py")
    demo = VisualizationDemo.__new__(VisualizationDemo)
    demo.threshold = 0.0  # draw every instance, labels included
    jdemo = jax_pred.VisualizationDemo.__new__(jax_pred.VisualizationDemo)
    jdemo.threshold = 0.0
    for preds in (got, {"sem_seg": got["sem_seg"]}):
        np.testing.assert_array_equal(demo.draw(img, preds), jdemo.draw(img, preds))
    inst = got["instances"]
    names = [f"class {i}" for i in range(k)]
    np.testing.assert_array_equal(
        overlay.overlay_instances(img, inst["scores"], inst["classes"], inst["masks"], names, 0.0),
        jax_cli.overlay_instances(img, inst["scores"], inst["classes"], inst["masks"], names, 0.0))
    np.testing.assert_array_equal(overlay.overlay_semantic(img, got["sem_seg"]),
                                  jax_cli.overlay_semantic(img, got["sem_seg"]))

    # the queue: results in submit order, an error raised by get()
    from mp_former_tpu_torch.demo import predictor as demo_predictor

    with mock.patch.object(demo_predictor, "Predictor",
                           lambda cfg: lambda image: {"mean": float(image.mean())}):
        ap = AsyncPredictor(None)
    frames = [np.full((2, 2, 3), v, np.uint8) for v in (1, 2, 3)]
    for f in frames:
        ap.put(f)
    assert len(ap) == 3
    assert [ap.get()["mean"] for _ in frames] == [1.0, 2.0, 3.0] and len(ap) == 0
    ap.put(None)
    with pytest.raises(AttributeError):
        ap.get()
    ap.shutdown()


def test_demo_and_predict_clis_match_jax(pan, capsys, monkeypatch):
    """The image demo and predict.py of both packages on the same image, the
    JAX mains fed the port's raw forward: the same PNG files, bit for bit.
    The JAX scripts import `predictor` from their own directory and
    `demo.demo` from the repository's root: both are handed the modules
    loaded here, whatever else of those names is on the path."""
    from mp_former_tpu_torch import predict as port_predict
    from mp_former_tpu_torch.demo import demo as port_demo

    root, img = pan["root"], pan["img"]
    raw = pan["port"].forward_raw(img)
    opts = [*PAN_SMALL, "MODEL.DEVICE", "cpu"]
    jax_pred = _load("jax_demo_predictor", "demo/predictor.py")
    jax_cli = _load("jax_demo_cli", "demo/demo.py")
    jax_predict = _load("jax_predict", "predict.py")
    monkeypatch.setitem(sys.modules, "predictor", jax_pred)
    monkeypatch.setitem(sys.modules, "demo.demo", jax_cli)

    port_demo.main(["--config-file", PAN_CONFIG, "--input", str(root / "img.npy"),
                    "--output", str(root / "port_demo"), "--confidence-threshold", "0",
                    *opts, "MODEL.WEIGHTS", pan["weights"]])
    with mock.patch.object(jax_pred.Predictor, "forward_raw", lambda self, image: raw), \
            mock.patch.object(sys, "argv", [
                "demo.py", "--config-file", PAN_CONFIG, "--input", str(root / "img.png"),
                "--output", str(root / "jax_demo"), "--confidence-threshold", "0", *PAN_SMALL]):
        jax_cli.main()
    for task in ("instance", "semantic"):
        got = cv2.imread(str(root / "port_demo" / f"img_{task}.png"))
        want = cv2.imread(str(root / "jax_demo" / f"img_{task}.png"))
        assert got is not None and want is not None
        np.testing.assert_array_equal(got, want)

    written = port_predict.main(["--image", str(root / "img.npy"), "--config-file", PAN_CONFIG,
                                 "--weights", pan["weights"], "--output",
                                 str(root / "port_pred"), *opts])
    with mock.patch.object(jax_predict.Predictor, "predict", lambda self, image: raw), \
            mock.patch.object(jax_pred.Predictor, "__init__", lambda self, cfg: None), \
            mock.patch.object(sys, "argv", [
                "predict.py", "--image", str(root / "img.png"), "--config-file", PAN_CONFIG,
                "--output", str(root / "jax_pred"), *PAN_SMALL]):
        jax_predict.main()
    assert [os.path.basename(p) for p in written] == [
        f"port_pred_{t}.png" for t in ("instance", "semantic", "panoptic")]
    for task in ("instance", "semantic", "panoptic"):
        np.testing.assert_array_equal(cv2.imread(str(root / f"port_pred_{task}.png")),
                                      cv2.imread(str(root / f"jax_pred_{task}.png")))
    out = capsys.readouterr().out
    assert "panoptic segments" in out


def test_video_demo_matches_jax(tmp_path):
    """`predict_clip` against the JAX demo's steps (`demo_video/demo.py:71-96`)
    on a 3-frame clip that needs no resize, then both TrackVisualizers."""
    from scipy.special import softmax

    from mp_former_tpu.utils.interp import resize as jax_resize

    from mp_former_tpu_torch.demo_video import visualizer
    from mp_former_tpu_torch.demo_video.demo import clip_size, predict_clip

    jcfg, jmodel, params, tcfg, tmodel = build_video_pair(frames=3)
    frames = list(np.random.RandomState(7).randint(0, 256, (3, *IMAGE_HW, 3), dtype=np.uint8))
    assert clip_size(tcfg, *IMAGE_HW) == IMAGE_HW
    scores, classes, tubes = predict_clip(tcfg, tmodel, frames)

    clip = np.stack([f[..., ::-1] for f in frames]).astype(np.float32)[None]
    out = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, None, train=False))(
        params, jnp.asarray(clip))
    flat = softmax(np.asarray(out["pred_logits"][0]), -1)[:, :-1].reshape(-1)
    top = np.argsort(-flat)[:10]
    k = jcfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    up = np.asarray(jax_resize(out["pred_masks"][0], IMAGE_HW, "bilinear"))[top // k]
    assert scores.shape == (10,) and tubes.shape == (10, 3, *IMAGE_HW)
    np.testing.assert_allclose(scores, flat[top], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(classes, top % k)
    np.testing.assert_array_equal(tubes | (np.abs(up) < 5e-2), (up > 0) | (np.abs(up) < 5e-2))

    jax_vis = _load("jax_visualizer", "demo_video/visualizer.py")
    for tid in range(45):
        np.testing.assert_array_equal(visualizer.track_color(tid), jax_vis.track_color(tid))
    names = [f"thing {i}" for i in range(k)]
    got = visualizer.TrackVisualizer(names).draw_clip(frames, tubes, classes, scores, 0.0)
    want = jax_vis.TrackVisualizer(names).draw_clip(frames, tubes, classes, scores, 0.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


_RUN_BLOCKED = textwrap.dedent("""
    import importlib.abc, runpy, sys
    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    sys.argv = {argv!r}
    runpy.run_module({module!r}, run_name="__main__")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NO_BLOCKED_IMPORTS")
""")


@pytest.mark.parametrize("entry", ["demo", "predict", "demo_video"])
def test_cli_runs_without_jax_cv2_or_pil(entry, pan, tmp_path):
    """The command line on `.npy` inputs where jax, the JAX package, cv2 and
    PIL cannot be imported: PNGs through zlib; the label-free drawings equal
    those written with cv2 in this process."""
    root, img = pan["root"], pan["img"]
    out = tmp_path / "out"
    if entry == "demo":
        module = "mp_former_tpu_torch.demo.demo"
        argv = ["demo", "--config-file", PAN_CONFIG, "--input", str(root / "img.npy"),
                "--output", str(out), *PAN_SMALL, "MODEL.DEVICE", "cpu",
                "MODEL.WEIGHTS", pan["weights"]]
        files = [out / "img_instance.png", out / "img_semantic.png"]
    elif entry == "predict":
        module = "mp_former_tpu_torch.predict"
        argv = ["predict", "--image", str(root / "img.npy"), "--config-file", PAN_CONFIG,
                "--weights", pan["weights"], "--output", str(out), *PAN_SMALL,
                "MODEL.DEVICE", "cpu"]
        files = [tmp_path / f"out_{t}.png" for t in ("instance", "semantic", "panoptic")]
    else:
        module = "mp_former_tpu_torch.demo_video.demo"
        clip = np.random.RandomState(8).randint(0, 256, (3, *IMAGE_HW, 3), dtype=np.uint8)
        np.save(tmp_path / "clip.npy", clip)
        argv = ["demo_video", "--config-file", "configs/" + VIDEO_R50, "--input",
                str(tmp_path / "clip.npy"), "--output", str(out), "--max-frames", "3",
                "--confidence-threshold", "0", *VIDEO_SMALL, "MODEL.DEVICE", "cpu"]
        files = [out / f"frame_{t:04d}.png" for t in range(3)]
    code = _RUN_BLOCKED.format(blocked=BLOCKED, argv=argv, module=module)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_BLOCKED_IMPORTS" in res.stdout
    assert "cv2 is not installed" in res.stderr
    for f in files:
        assert f.is_file(), f
        assert cv2.imread(str(f)) is not None and cv2.imread(str(f)).shape[:2] == IMAGE_HW
    if entry == "demo":
        semantic = cv2.imread(str(files[1]))
        want = overlay.overlay_semantic(img, pan["port"](img)["sem_seg"])
        np.testing.assert_array_equal(semantic, want)
    if entry == "predict":
        from mp_former_tpu_torch.predict import Predictor as PortPredict

        pred = PortPredict()
        pred.setup(PAN_CONFIG, pan["weights"], [*PAN_SMALL, "MODEL.DEVICE", "cpu"])
        drawn = pred.drawings(img)
        for task, f in (("semantic", files[1]), ("panoptic", files[2])):
            np.testing.assert_array_equal(cv2.imread(str(f)), drawn[task])
