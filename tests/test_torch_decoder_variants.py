"""The decoder variants of the port against the JAX package, at a small size:
LYSmooth (LAST_Q_RATIO), pre-norm (PRE_NORM), dropout (DROPOUT) in training
mode, and the train/eval modes that `Trainer`, `Trainer.test` and
`Predictor` set.

Dropout draws are random streams of their own: the test records what
`jax.random.bernoulli` returns inside the JAX model (flax's `nn.Dropout`)
and hands the port the same masks in the same order through the one
function the port draws them with (`utils/layers.py:keep_mask`), as
tests/test_torch_dn_decoder.py replays `uniform`. Tolerances as
tests/test_torch_dn_decoder.py: logits 1e-3, mask logits 1e-2 (float32).
With TPU.REMAT_ENCODER the encoder layers are recomputed in the backward;
their dropout masks are drawn before the recomputed region, so remat on and
off give the same gradients (within 1e-6 of each gradient's largest entry, as
tests/test_torch_remat.py holds remat without dropout).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine.checkpoint_import import convert_predictor
from mp_former_tpu.models.transformer_decoder.mask2former_decoder import (
    MultiScaleMaskedTransformerDecoderMaskDN as JaxMaskDN,
    MultiScaleMaskedTransformerDecoderMaskDNLYSmooth as JaxLYSmooth)
from mp_former_tpu.structures import DNArgs as JDNArgs

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.data.synthetic import synthetic_batches
from mp_former_tpu_torch.engine.predictor import Predictor
from mp_former_tpu_torch.engine.trainer import Trainer
from mp_former_tpu_torch.models import build_model
from mp_former_tpu_torch.models.transformer_decoder import mask2former_decoder as tdec
from mp_former_tpu_torch.structures import DNArgs
from mp_former_tpu_torch.utils import layers

from test_torch_dn_decoder import DN, make_targets, record_jax_draws, replay_draws
from test_torch_dn_modes import DEC, _check, _inputs
from test_torch_slice import SMALL, _build_pair, _cfg

torch.set_num_threads(2)


def record_jax_bernoulli(monkeypatch):
    """Record every `jax.random.bernoulli` result (flax's dropout masks) in
    call order; inside a jitted call the list holds tracers."""
    recorded = []
    real = jax.random.bernoulli

    def bernoulli(*args, **kwargs):
        out = real(*args, **kwargs)
        recorded.append(out)
        return out

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return recorded


def replay_keep_masks(monkeypatch, recorded):
    """Make `utils.layers.keep_mask` hand out the recorded masks in order."""
    def keep_mask(shape, rate, generator, device):
        rec = recorded.pop(0)
        assert rec.shape == tuple(shape), (rec.shape, tuple(shape))
        return torch.from_numpy(rec.copy())

    monkeypatch.setattr(layers, "keep_mask", keep_mask)


@pytest.mark.parametrize("variant", ["lysmooth", "pre_norm"])
def test_lysmooth_and_pre_norm_decoders_match_jax(monkeypatch, variant):
    """The MaskDN decoder with LAST_Q_RATIO 0.3 (the LYSmooth decoder: an EMA
    of the mask embeddings across the layers, the DN rows' included) or with
    pre-norm layers, in DN training (`points`, noise 0.2, label noise 0.2,
    HEAD_DN) and at inference; the cfg keys reach the port's decoder."""
    kw = {"last_q_ratio": 0.3} if variant == "lysmooth" else {"pre_norm": True}
    jcls = JaxLYSmooth if variant == "lysmooth" else JaxMaskDN
    tcls = (tdec.MultiScaleMaskedTransformerDecoderMaskDNLYSmooth if variant == "lysmooth"
            else tdec.MultiScaleMaskedTransformerDecoderMaskDN)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tdecoder = tcls(32, num_classes=5, hidden_dim=32, num_queries=6, nheads=4,
                        dim_feedforward=64, dec_layers=3, mask_dim=32, dn_mode="points",
                        head_dn=True, all_lys=True, dn_label_noise_ratio=0.2, **kw).eval()
    params = convert_predictor({k: v.numpy() for k, v in tdecoder.state_dict().items()}, "")
    jdecoder = jcls(**DEC, dn_mode="points", head_dn=True, all_lys=True,
                    dn_label_noise_ratio=0.2, **kw)
    x, mf, jt, tt = _inputs()
    xs = [jnp.asarray(a) for a in x]
    jmf = jnp.asarray(mf.transpose(0, 2, 3, 1))
    tx = [torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in x]
    recorded = record_jax_draws(monkeypatch, 5)

    @jax.jit
    def apply(p):
        out = jdecoder.apply({"params": p}, xs, jmf, JDNArgs(targets=jt, scalar=2, noise_scale=0.2),
                             train=True, rngs={"dn": jax.random.PRNGKey(2)})
        return out, list(recorded)

    want, draws = apply(params)
    want_eval = jax.jit(lambda p: jdecoder.apply({"params": p}, xs, jmf, None))(params)
    monkeypatch.undo()
    draws = [np.asarray(d) for d in draws]
    replay_draws(monkeypatch, tdec, draws)
    with torch.no_grad():
        got = tdecoder(tx, torch.from_numpy(mf), DNArgs(targets=tt, scalar=2, noise_scale=0.2))
        got_eval = tdecoder(tx, torch.from_numpy(mf))
    assert not draws
    for g, w, what in [(got, want, "final"), (got["dn_out"], want["dn_out"], "dn final"),
                       (got_eval, want_eval, "inference")]:
        _check(g, w, what)
        for i, (ga, wa) in enumerate(zip(g["aux_outputs"], w["aux_outputs"])):
            _check(ga, wa, f"{what} aux {i}")
    # the variant changes the function: the plain decoder's outputs differ
    plain = tdec.MultiScaleMaskedTransformerDecoderMaskDN(
        32, num_classes=5, hidden_dim=32, num_queries=6, nheads=4, dim_feedforward=64,
        dec_layers=3, mask_dim=32).eval()
    plain.load_state_dict(tdecoder.state_dict())
    with torch.no_grad():
        changed = plain(tx, torch.from_numpy(mf))["pred_masks"] - got_eval["pred_masks"]
    assert changed.abs().max() > 1e-2
    cfg = _cfg(get_cfg, add_deeplab_config, add_maskformer2_config, SMALL + [
        "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME", tcls.__name__,
        "MODEL.MASK_FORMER.LAST_Q_RATIO", "0.3", "MODEL.MASK_FORMER.PRE_NORM", "True"])
    built = tdec.build_transformer_decoder(cfg, 32)
    assert type(built) is tcls and built.last_q_ratio == 0.3
    assert built.transformer_ffn_layers[0].normalize_before


DROPOUT = SMALL + DN + ["MODEL.MASK_FORMER.DROPOUT", "0.1", "MODEL.DN.NUM_DN", "1",
                        "MODEL.DN.NOISE_SCALE", "0.0", "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.0"]


def test_dropout_in_training_matches_jax(monkeypatch):
    """DROPOUT 0.1 acts on the deformable encoder's layers (after the
    attention, the FFN's ReLU and its output; the Mask2Former decoder keeps
    0.0): the JAX model's dropout masks replayed in the port in training
    mode (one encoder layer, three masks); in eval mode the port's outputs
    are the JAX inference's. Remat is off: flax's remat traces its layers
    apart, and a recorded mask would leak out of that trace (remat is held
    in the test below)."""
    jcfg, jmodel, params, tcfg, tmodel, img = _build_pair(
        DROPOUT + ["TPU.REMAT_ENCODER", "False"], (64, 64))
    assert tmodel.sem_seg_head.pixel_decoder.transformer.encoder.layers[0].dropout == 0.1
    jt, tt = make_targets(b=1, counts=(3,))
    recorded = record_jax_bernoulli(monkeypatch)

    @jax.jit
    def apply(p, x):
        out = jmodel.apply({"params": p}, x, jt, train=True,
                           rngs={"dn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)})
        return out, list(recorded)

    want, masks = apply(params, jnp.asarray(img))
    want_eval = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, None, train=False))(
        params, jnp.asarray(img))
    monkeypatch.undo()
    masks = [np.asarray(m) for m in masks]
    assert len(masks) == 1 * 3 and 0.8 < np.mean([m.mean() for m in masks]) < 1.0
    replay_keep_masks(monkeypatch, masks)
    with torch.no_grad():
        got = tmodel.train()(torch.from_numpy(img), tt)
        got_eval = tmodel.eval()(torch.from_numpy(img))
    assert not masks, "the port drew fewer dropout masks than the JAX model"
    for g, w, what in [(got, want, "train"), (got["dn_out"], want["dn_out"], "dn"),
                       (got_eval, want_eval, "eval")]:
        _check(g, w, what)
        for i, (ga, wa) in enumerate(zip(g["aux_outputs"], w["aux_outputs"])):
            _check(ga, wa, f"{what} aux {i}")
    assert (got["pred_masks"] - got_eval["pred_masks"]).abs().max() > 1e-2  # dropout acted


def test_trainer_trains_in_train_mode_and_evaluates_in_eval_mode(tmp_path, monkeypatch):
    """`build_model` returns `.eval()`; `Trainer` sets `.train()`;
    `Trainer.test` evaluates in `.eval()` (here through a stand-in for
    `run_evaluation`) and puts the model back; `Predictor` sets `.eval()`."""
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.engine import eval_loop

    cfg = _cfg(get_cfg, add_deeplab_config, add_maskformer2_config,
               DROPOUT + ["OUTPUT_DIR", str(tmp_path), "DATASETS.TEST", "('modes_probe',)"])
    model = build_model(cfg)
    assert not model.training
    trainer = Trainer(cfg, synthetic_batches(2, 64, 80, 5), model=model, device="cpu")
    assert trainer.model.training and all(m.training for m in trainer.model.modules())
    seen = []

    def evaluation(cfg_, model_, name, max_images):
        seen.append(model_.training)
        Predictor(cfg_, model=model_, device="cpu")
        seen.append(model_.training)
        return {"probe": {"x": 1.0}}

    monkeypatch.setattr(eval_loop, "run_evaluation", evaluation)
    monkeypatch.setitem(DatasetCatalog._registry, "modes_probe", lambda: [])
    assert trainer.test() == {"probe": {"x": 1.0}}
    assert seen == [False, False] and trainer.model.training
    trainer.run_step(next(synthetic_batches(2, 64, 80, 5)))
    assert trainer.model.training


def test_remat_gives_the_gradients_of_no_remat_with_dropout():
    """TPU.REMAT_ENCODER with DROPOUT 0.1: the recompute in the backward
    drops what the forward dropped (the masks are drawn before the
    recomputed region), so the forward is bitwise equal and every gradient
    within 1e-6 of its largest entry to the step without remat, from the
    same generator seed; and the masks did act."""
    grads, outs = {}, {}
    jt, tt = make_targets(b=1, counts=(3,))
    for remat in (True, False):
        cfg = _cfg(get_cfg, add_deeplab_config, add_maskformer2_config,
                   DROPOUT + ["TPU.REMAT_ENCODER", str(remat)])
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model(cfg).train()
        img = torch.from_numpy(np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32) * 255)
        out = model(img, tt, generator=torch.Generator().manual_seed(7))
        loss = sum((o["pred_masks"] ** 2).mean() + o["pred_logits"].square().mean()
                   for o in [out, *out["aux_outputs"], out["dn_out"]])
        loss.backward()
        outs[remat] = out["pred_masks"].detach()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        assert model.sem_seg_head.pixel_decoder.transformer.remat is remat
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)
    assert grads[True].keys() == grads[False].keys()
    for n, g in grads[False].items():
        scale = max(g.abs().max().item(), 1e-12)
        assert (grads[True][n] - g).abs().max().item() <= 1e-6 * scale, n
    with torch.no_grad():
        model.eval()
        plain = model(img)["pred_masks"]
    assert (plain - outs[False]).abs().max() > 1e-2
