"""MaskFormer-v1's modules in the port against the JAX package, at a small
size: the FPN pixel decoders (`BasePixelDecoder`,
`TransformerEncoderPixelDecoder`), `StandardTransformerDecoder`, every
`TRANSFORMER_IN_FEATURE`, the per-pixel baseline heads and
`per_pixel_ce_loss`.

The model is the ADE20K semantic R50 recipe with the v1 switches, at the
narrow widths of tests/test_torch_slice.py:SMALL (3 decoder layers, 4 heads),
its weights the port's seeded init carried into the JAX layout by the JAX
importer (`_build_pair`), so the test also holds that the port keeps the
reference's state-dict names. Dropout is replayed from the JAX side's
`jax.random.bernoulli` (tests/test_torch_decoder_variants.py). Tolerances as
tests/test_torch_slice.py: logits 1e-3, mask logits 1e-2; one training step's
losses 1e-4 relative and gradients 1e-3 of each parameter's largest entry
(float32). The per-pixel heads have no training step in the JAX package, so
only their forward and the loss function are held.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.engine.checkpoint_import import (convert_pixel_decoder,
                                                    convert_standard_predictor)
from mp_former_tpu.engine.convert import d2_resnet_params_from_state_dict
from mp_former_tpu.models import build_model as jax_build_model
from mp_former_tpu.models.criterion import build_criterion as jax_build_criterion
from mp_former_tpu.models.matcher import _lsa_host
from mp_former_tpu.models.meta_arch.per_pixel_baseline import (
    per_pixel_ce_loss as jax_per_pixel_ce_loss)

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.engine.convert import (load_weights, named_gradients_from_jax,
                                                state_dict_from_jax_params)
from mp_former_tpu_torch.engine.optimizer import build_optimizer
from mp_former_tpu_torch.engine.train_step import train_step
from mp_former_tpu_torch.models import build_model
from mp_former_tpu_torch.models.criterion import build_criterion
from mp_former_tpu_torch.models.meta_arch.per_pixel_baseline import per_pixel_ce_loss
from mp_former_tpu_torch.structures import Batch

from test_torch_decoder_variants import record_jax_bernoulli, replay_keep_masks
from test_torch_dn_decoder import make_targets
from test_torch_dn_modes import _check
from test_torch_slice import SMALL, _build_pair, _cfg, _perturb

torch.set_num_threads(2)

ADE = "configs/ade20k/semantic-segmentation/maskformer2_R50_bs16_160k.yaml"
IMG = (64, 64)
# the v1 switches at the values mp_former_tpu/config/defaults.py gives them,
# at SMALL's widths
V1 = SMALL + ["MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME", "BasePixelDecoder",
              "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME", "StandardTransformerDecoder",
              "MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE", "res5",
              "MODEL.MASK_FORMER.DEC_LAYERS", "3", "MODEL.MASK_FORMER.NHEADS", "4",
              "MODEL.MASK_FORMER.DROPOUT", "0.1", "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "0"]
VARIANTS = {
    "res5": [],
    # the transformer encoder pixel decoder, pre-norm, and the decoder's own
    # DETR encoder (ENC_LAYERS), in training mode
    "transformer_encoder": ["MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME",
                            "TransformerEncoderPixelDecoder",
                            "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "2",
                            "MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE", "transformer_encoder",
                            "MODEL.MASK_FORMER.PRE_NORM", "True",
                            "MODEL.MASK_FORMER.ENC_LAYERS", "1"],
    "pixel_embedding": ["MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE", "pixel_embedding"],
    # the FPN's maps under the masked-attention decoder (JAX tests/test_other_decoders.py)
    "multi_scale_pixel_decoder": ["MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE",
                                  "multi_scale_pixel_decoder",
                                  "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME",
                                  "MultiScaleMaskedTransformerDecoder",
                                  "MODEL.MASK_FORMER.DEC_LAYERS", "4"],
}


def _check_all(got, want, what):
    _check(got, want, what)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) > 0
    for i, (g, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        _check(g, w, f"{what} aux {i}")


@pytest.mark.parametrize("feature", list(VARIANTS))
def test_v1_model_forward_matches_jax(monkeypatch, feature):
    """Each TRANSFORMER_IN_FEATURE with its pixel decoder; the
    transformer-encoder variant also in training mode, the JAX model's
    dropout masks replayed."""
    jcfg, jmodel, params, tcfg, tmodel, img = _build_pair(V1 + VARIANTS[feature], IMG, ADE)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, None, train=False))(
        params, jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    assert got["pred_logits"].shape == (1, 8, 151)
    _check_all(got, want, "eval")
    if feature != "transformer_encoder":
        return
    recorded = record_jax_bernoulli(monkeypatch)

    @jax.jit
    def apply(p, x):
        return jmodel.apply({"params": p}, x, None, train=True,
                            rngs={"dropout": jax.random.PRNGKey(2)}), list(recorded)

    want_train, masks = apply(params, jnp.asarray(img))
    monkeypatch.undo()
    masks = [np.asarray(m) for m in masks]
    # 2 encoder layers x 4 (attention weights, attention, ReLU, FFN), the
    # decoder's encoder layer x 4, 3 decoder layers x 6
    assert len(masks) == 2 * 4 + 4 + 3 * 6
    replay_keep_masks(monkeypatch, masks)
    with torch.no_grad():
        got_train = tmodel.train()(torch.from_numpy(img))
    assert not masks
    _check_all(got_train, want_train, "train")
    assert (got_train["pred_masks"] - got["pred_masks"]).abs().max() > 1e-2  # dropout acted


def test_v1_step_matches_jax(monkeypatch):
    """One training step of the v1 model (BasePixelDecoder, res5,
    StandardTransformerDecoder, DROPOUT 0.1 in training mode): the JAX step
    trains it (its DN loss terms are 0: the decoder has no DN queries), and
    the port's losses and gradients match it, the dropout masks replayed."""
    overrides = V1 + ["MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256",
                      "MODEL.MASK_FORMER.IMPORTANCE_SAMPLE_RATIO", "1.0",
                      "SOLVER.CLIP_GRADIENTS.ENABLED", "False", "MODEL.BACKBONE.FREEZE_AT", "2"]
    jcfg, jmodel, params, tcfg, tmodel, img = _build_pair(overrides, IMG, ADE)
    img = np.concatenate([img, img[:, ::-1]], 0)
    jt, tt = make_targets(n=6, counts=(3, 1))
    jcrit, tcrit = jax_build_criterion(jcfg), build_criterion(tcfg)
    rngs = {"dn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    rng_loss = jax.random.PRNGKey(3)
    num_masks = jnp.maximum(jt.valid.sum().astype(jnp.float32), 1.0)
    recorded = record_jax_bernoulli(monkeypatch)

    @jax.jit
    def cost_pass(p):
        outputs = jmodel.apply({"params": p}, jnp.asarray(img), jt, train=True, rngs=rngs)
        masks = list(recorded)
        return jcrit.layer_costs(outputs, jt, rng_loss)[0], masks

    costs, masks = cost_pass(params)
    monkeypatch.undo()
    masks = [np.asarray(m) for m in masks]
    replay_keep_masks(monkeypatch, masks)
    l, b, q, n = costs.shape
    assignments = _lsa_host(np.asarray(costs).reshape(l * b, q, n)).reshape(l, b, n)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(img), jt, train=True, rngs=rngs)
        losses = jcrit(out, jt, rng_loss, num_masks=num_masks,
                       assignments=jnp.asarray(assignments))
        return jcrit.weighted_total(losses), losses

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = copy.deepcopy(tmodel).train()
    optimizer, scheduler = build_optimizer(tcfg, model)
    tcrit.assign = lambda costs: torch.from_numpy(assignments.astype(np.int64))
    metrics = train_step(model, tcrit, optimizer, scheduler, Batch(torch.from_numpy(img), tt),
                         torch.Generator().manual_seed(0))
    assert not masks
    want = {k: float(v) for k, v in jlosses.items()}
    assert set(metrics) == set(want) | {"total_loss"}
    assert len(want) == 3 * 3 * 2  # 2 aux layers + final, main and (zero) DN terms
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
        assert (v > 0) == ("_dn" not in k), k
    np.testing.assert_allclose(metrics["total_loss"].item(), float(jtotal), rtol=1e-4)
    grads = named_gradients_from_jax(jax.tree.map(np.asarray, jgrads), model)
    largest = max(g.abs().max().item() for g in grads.values())
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    for name in names:
        p = dict(model.named_parameters())[name]
        scale = max(grads[name].abs().max().item(), 1e-4 * largest)
        assert (p.grad - grads[name]).abs().max().item() <= 1e-3 * scale, name
    for part in ("pixel_decoder.adapter_1", "pixel_decoder.layer_4", "predictor.query_embed",
                 "transformer.decoder.layers.2.multihead_attn", "transformer.decoder.norm"):
        assert any(part in n for n in names), part


def _head_params(sd):
    """The JAX params of a per-pixel baseline model from the port's state
    dict (the JAX importer reads no per-pixel head)."""
    head = {"pixel_decoder": convert_pixel_decoder(sd)}
    if "sem_seg_head.predictor.weight" in sd:
        head["predictor"] = {"kernel": sd["sem_seg_head.predictor.weight"].transpose(2, 3, 1, 0),
                             "bias": sd["sem_seg_head.predictor.bias"]}
    else:
        head["predictor"] = convert_standard_predictor(sd)
    return {"backbone": d2_resnet_params_from_state_dict(sd, "backbone."), "sem_seg_head": head}


def test_per_pixel_heads_and_loss_match_jax():
    """PerPixelBaselineHead and PerPixelBaselinePlusHead (whose predictor is a
    StandardTransformerDecoder at its default widths, as the JAX head builds
    it): per-pixel logits at the input size in eval mode, and
    `per_pixel_ce_loss` on them with ignored pixels."""
    rng = np.random.RandomState(0)
    img = (rng.rand(1, *IMG, 3) * 255).astype(np.float32)
    sem = rng.randint(0, 150, (1, *IMG))
    sem[:, :8] = 255
    for head in ("PerPixelBaselineHead", "PerPixelBaselinePlusHead"):
        overrides = V1 + ["MODEL.SEM_SEG_HEAD.NAME", head]
        tcfg = _cfg(get_cfg, add_deeplab_config, add_maskformer2_config, overrides, ADE)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            tmodel = build_model(tcfg)
        params = _perturb(_head_params({k: v.numpy() for k, v in tmodel.state_dict().items()}),
                          rng)
        load_weights(tmodel, state_dict_from_jax_params(params))
        jmodel = jax_build_model(_cfg(jax_get_cfg, jax_add_deeplab, jax_add_mf2, overrides, ADE))
        want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, None, train=False))(
            params, jnp.asarray(img))
        with torch.no_grad():
            got = tmodel(torch.from_numpy(img))
        want_logits = np.asarray(want["sem_seg_logits"]).transpose(0, 3, 1, 2)
        assert got["sem_seg_logits"].shape == want_logits.shape == (1, 150, *IMG)
        assert np.abs(got["sem_seg_logits"].numpy() - want_logits).max() < 1e-3, head
        if head == "PerPixelBaselinePlusHead":
            _check_all(got, want, head)
        loss = per_pixel_ce_loss(got["sem_seg_logits"], torch.from_numpy(sem))
        want_loss = jax_per_pixel_ce_loss(jnp.asarray(want_logits.transpose(0, 2, 3, 1)),
                                          jnp.asarray(sem))
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, err_msg=head)
    everything_ignored = per_pixel_ce_loss(got["sem_seg_logits"], torch.full((1, *IMG), 255))
    assert everything_ignored.item() == 0.0
