"""The recipes of ADE20K, Cityscapes and Mapillary Vistas end to end against
the JAX package, at a small size: their decoder (the vanilla
`MultiScaleMaskedTransformerDecoder`, no DN) in a forward and its losses, and
`run_evaluation` on a semantic dataset (`sem_seg`: mIoU) and on a Cityscapes
instance dataset (`cityscapes_instance`: the official AP), both written here,
the port reading `.npy` files and the JAX package the same pixels and maps as
PNG / JPEG.

The ground truth is the port's own predictions (the semantic argmax; the
instances painted by `tools/make_synthetic_segm_torch.py:
instance_ids_from_predictions`, on which they score AP 100), so the scores sit
far from 0 and any drift of canvas, resize, post-processing or evaluator moves
them. Scores within 0.1 of the JAX package's (the bound of
tests/test_e2e_pq_miou_oracle.py); logits within 1e-3 and mask logits within
1e-2 (tests/test_torch_slice.py); losses within 1e-4 relative.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp_former_tpu.data.datasets.register_all import (
    register_cityscapes_instance as jax_register_cityscapes_instance,
    register_sem_seg as jax_register_sem_seg)
from mp_former_tpu.engine.checkpoint_import import convert_maskformer_state_dict
from mp_former_tpu.engine.eval_loop import run_evaluation as jax_run_evaluation
from mp_former_tpu.models.criterion import build_criterion as jax_build_criterion
from mp_former_tpu.models.matcher import _lsa_host

from mp_former_tpu_torch.data.datasets.cityscapes_labels import INSTANCE_LABELS
from mp_former_tpu_torch.data.datasets.register_all import (register_cityscapes_instance,
                                                            register_sem_seg)
from mp_former_tpu_torch.engine.eval_loop import run_evaluation
from mp_former_tpu_torch.engine.predictor import Predictor
from mp_former_tpu_torch.models.criterion import build_criterion

from test_torch_dn_decoder import make_targets
from test_torch_segm_recipes import VANILLA
from test_torch_slice import _build_pair
from tools.make_synthetic_segm_torch import instance_ids_from_predictions

torch.set_num_threads(2)

CONFIG = "configs/ade20k/semantic-segmentation/maskformer2_R50_bs16_160k.yaml"
K = 8  # the Cityscapes instance recipe's class count
SMALL_SEGM = VANILLA + [
    "MODEL.SEM_SEG_HEAD.NUM_CLASSES", str(K), "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256",
    "MODEL.MASK_FORMER.IMPORTANCE_SAMPLE_RATIO", "1.0", "MODEL.MASK_FORMER.DROPOUT", "0.0"]
SIZES = [(64, 96), (64, 96), (64, 96)]
SCORE_TOL = 0.1
SHARPEN = 50.0


@pytest.fixture(scope="module")
def pair():
    """The two packages' models with the same weights; the class and mask
    embeddings' last layers scaled by SHARPEN in both, so that the queries'
    classes and masks part (at the small random init the masks are one map
    up to scale and the semantic argmax one class)."""
    jcfg, jmodel, _, tcfg, tmodel, img = _build_pair(SMALL_SEGM, SIZES[0], CONFIG)
    assert tcfg.MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME == "MultiScaleMaskedTransformerDecoder"
    sd = {k: v * SHARPEN if k.startswith(("sem_seg_head.predictor.class_embed.",
                                          "sem_seg_head.predictor.mask_embed.layers.2."))
          else v for k, v in tmodel.state_dict().items()}
    tmodel.load_state_dict(sd)
    params = convert_maskformer_state_dict({k: v.numpy() for k, v in sd.items()})
    jcfg = jcfg.clone()
    jcfg.merge_from_list(["TPU.EVAL_BUCKET_STEP", "32"])
    return jcfg, jmodel, params, tcfg, tmodel, img


def test_vanilla_decoder_forward_and_losses_match_jax(pair):
    jcfg, jmodel, params, tcfg, tmodel, img = pair
    img = np.concatenate([img, img[:, ::-1]], 0)
    jt, tt = make_targets(n=6, size=img.shape[1], counts=(3, 1), classes=K)
    rngs = {"dropout": jax.random.PRNGKey(2)}
    want = jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(img), jt, train=True,
                                          rngs=rngs))(params)
    tmodel.train()
    try:
        with torch.no_grad():
            got = tmodel(torch.from_numpy(img), tt)
    finally:
        tmodel.eval()
    layers = [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"]))
    assert len(layers) == 4  # DEC_LAYERS 4: 3 layers and the learnable queries' prediction
    for g, w in layers:
        assert np.abs(g["pred_logits"].numpy() - np.asarray(w["pred_logits"])).max() < 1e-3
        assert np.abs(g["pred_masks"].numpy() - np.asarray(w["pred_masks"])).max() < 1e-2

    jcrit, tcrit = jax_build_criterion(jcfg), build_criterion(tcfg)
    rng = jax.random.PRNGKey(3)
    costs = jax.jit(lambda o, t, r: jcrit.layer_costs(o, t, r)[0])(want, jt, rng)
    l, b, q, n = costs.shape
    assignments = _lsa_host(np.asarray(costs).reshape(l * b, q, n)).reshape(l, b, n)
    num_masks = float(np.asarray(jt.valid).sum())
    jlosses = jax.jit(lambda o, t, r, nm, a: jcrit(o, t, r, num_masks=nm, assignments=a))(
        want, jt, rng, jnp.float32(num_masks), jnp.asarray(assignments))
    tlosses = tcrit(got, tt, None, num_masks=torch.tensor(num_masks),
                    assignments=torch.from_numpy(assignments.astype(np.int64)))
    # 4 layers x ce, mask, dice, and the DN keys at 0 (the reference's loss schema)
    assert set(tlosses) == set(jlosses) and len(jlosses) == 24
    assert all(float(v) == 0 for k, v in jlosses.items() if "_dn" in k)
    for k, v in jlosses.items():
        np.testing.assert_allclose(tlosses[k].item(), float(v), rtol=1e-4, atol=1e-6, err_msg=k)


def _jpeg_pixels(path, image):
    """The pixels a reader of the JPEG file gets (the JAX registrations name
    `.jpg` images): both packages see the same image."""
    cv2.imwrite(path, image, [cv2.IMWRITE_JPEG_QUALITY, 100])
    return cv2.imread(path, cv2.IMREAD_COLOR)


def test_semantic_run_evaluation_matches_jax(pair, tmp_path):
    jcfg, jmodel, params, tcfg, tmodel, _ = pair
    predictor = Predictor(tcfg, model=tmodel, device="cpu")
    rng = np.random.RandomState(5)
    dirs = {form: {d: tmp_path / form / d for d in ("img", "gt")} for form in ("npy", "png")}
    for d in (p for form in dirs.values() for p in form.values()):
        d.mkdir(parents=True)
    classes_seen = set()
    for i, (h, w) in enumerate(SIZES):
        img = _jpeg_pixels(str(dirs["png"]["img"] / f"{i}.jpg"),
                           rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        np.save(str(dirs["npy"]["img"] / f"{i}.npy"), img)
        sem = predictor(img, tasks=["semantic"])["sem_seg"].argmax(0).astype(np.uint8)
        sem[:4] = 255  # an ignored band
        classes_seen |= set(np.unique(sem[4:]).tolist())
        np.save(str(dirs["npy"]["gt"] / f"{i}.npy"), sem)
        cv2.imwrite(str(dirs["png"]["gt"] / f"{i}.png"), sem)
    assert len(classes_seen) > 1, "the model predicts one class: the comparison would be vacuous"
    classes = [f"c{c}" for c in range(K)]
    register_sem_seg("torch_segm_eval_sem", str(dirs["npy"]["img"]), str(dirs["npy"]["gt"]),
                     classes)
    jax_register_sem_seg("torch_segm_eval_sem", str(dirs["png"]["img"]), str(dirs["png"]["gt"]),
                         classes)
    got = run_evaluation(tcfg, tmodel, "torch_segm_eval_sem")
    want = jax_run_evaluation(jcfg, jmodel, {"params": params}, "torch_segm_eval_sem")
    assert got.keys() == want.keys() == {"sem_seg"}
    assert got["sem_seg"]["mIoU"] > 95
    for k in ("mIoU", "fwIoU", "mACC", "pACC"):
        assert abs(got["sem_seg"][k] - want["sem_seg"][k]) <= SCORE_TOL, k


def test_cityscapes_instance_run_evaluation_matches_jax(pair, tmp_path):
    jcfg, jmodel, params, tcfg, tmodel, _ = pair
    predictor = Predictor(tcfg, model=tmodel, device="cpu")
    thing_ids = np.array([lab.id for lab in INSTANCE_LABELS])
    rng = np.random.RandomState(6)
    for form in ("npy", "png"):
        for d in ("leftImg8bit", "gtFine"):
            (tmp_path / form / d / "city").mkdir(parents=True)
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SIZES]
    predictions = [predictor(img, tasks=["instance"])["instances"] for img in images]
    maps = instance_ids_from_predictions(
        [(p["scores"], p["classes"], p["masks"]) for p in predictions], thing_ids)
    painted = sum(len(np.unique(ids[ids >= 1000])) for ids in maps)
    for i, ((h, w), img, ids) in enumerate(zip(SIZES, images, maps)):
        stem = f"city_{i:06d}_000019"
        for form, save in (("npy", np.save), ("png", cv2.imwrite)):
            save(str(tmp_path / form / "leftImg8bit" / "city" / f"{stem}_leftImg8bit.{form}"), img)
            gt = tmp_path / form / "gtFine" / "city" / f"{stem}_gtFine_"
            save(f"{gt}instanceIds.{form}", ids.astype(np.uint16))
            # the records' size (Cityscapes' own 1024x2048 where no polygon file says)
            (tmp_path / form / "gtFine" / "city" / f"{stem}_gtFine_polygons.json").write_text(
                json.dumps({"imgHeight": h, "imgWidth": w, "objects": []}))
    assert painted > 0, "no prediction became ground truth: the comparison would be vacuous"
    register_cityscapes_instance("torch_segm_eval_cs", str(tmp_path / "npy" / "leftImg8bit"),
                                 str(tmp_path / "npy" / "gtFine"))
    jax_register_cityscapes_instance("torch_segm_eval_cs", str(tmp_path / "png" / "leftImg8bit"),
                                     str(tmp_path / "png" / "gtFine"))
    got = run_evaluation(tcfg, tmodel, "torch_segm_eval_cs")
    want = jax_run_evaluation(jcfg, jmodel, {"params": params}, "torch_segm_eval_cs")
    assert got.keys() == want.keys() == {"segm"}
    assert got["segm"]["AP"] == 100.0
    for k, v in want["segm"].items():
        if np.isnan(v):
            assert np.isnan(got["segm"][k]), k
        else:
            assert abs(got["segm"][k] - v) <= SCORE_TOL, k
