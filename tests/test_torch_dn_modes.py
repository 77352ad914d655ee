"""Every DN (mask-piloted) mode of the port's MaskDN decoder against the JAX
decoder, at the tiny sizes of tests/test_dn_modes.py: three levels of 4, 8
and 16 pixels, 32 channels, 6 queries, 4 heads, 3 layers, two groups.

The JAX side is jitted; its `jax.random.uniform` / `randint` draws are
recorded in call order and replayed through the one function the port's
decoder draws with (tests/test_torch_dn_decoder.py:record_jax_draws), so the
order of the draws is held too: a port that draws in another order, or
another number of times, fails. The static3 modes' blocked masks are held
bit for bit, the decoder's outputs to the tolerances of
tests/test_torch_dn_decoder.py (logits 1e-3, mask logits 1e-2, float32), and
one model-level step of `base` and of `shift_scale` (losses 1e-4 relative,
gradients 1e-3 of each parameter's largest entry) through
tests/test_torch_slice.py:_build_pair.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine.checkpoint_import import convert_predictor
from mp_former_tpu.models.criterion import build_criterion as jax_build_criterion
from mp_former_tpu.models.matcher import _lsa_host
from mp_former_tpu.models.transformer_decoder.mask2former_decoder import (
    MultiScaleMaskedTransformerDecoderMaskDN as JaxMaskDN)
from mp_former_tpu.structures import DNArgs as JDNArgs, Targets as JTargets

from mp_former_tpu_torch.data.synthetic import synthetic_batches
from mp_former_tpu_torch.engine.convert import named_gradients_from_jax
from mp_former_tpu_torch.engine.optimizer import build_optimizer
from mp_former_tpu_torch.engine.train_step import train_step
from mp_former_tpu_torch.engine.trainer import Trainer
from mp_former_tpu_torch.models.criterion import build_criterion
from mp_former_tpu_torch.models.transformer_decoder import mask2former_decoder as tdec
from mp_former_tpu_torch.structures import Batch, DNArgs, Targets

from test_torch_dn_decoder import IMG, make_targets, record_jax_draws, replay_draws
from test_torch_slice import SMALL, _build_pair, _cfg
from test_torch_train_step import TRAIN, check_losses

torch.set_num_threads(2)

STATIC3 = ["shift", "scale", "shift_scale", "patch", "points_MAE"]
DEC = dict(in_channels=32, num_classes=5, hidden_dim=32, num_queries=6, nheads=4,
           dim_feedforward=64, dec_layers=3, mask_dim=32)
SIZES = (4, 8, 16)


def _inputs(seed=0):
    """Two images' multi-scale maps (NHWC for JAX, NCHW for the port), mask
    features and three padded targets each, of varied rectangles and boxes
    (tests/test_dn_modes.py:_inputs with a batch of two)."""
    rng = np.random.RandomState(seed)
    x = [rng.randn(2, s, s, 32).astype(np.float32) for s in SIZES]
    mf = rng.randn(2, 32, 32, 32).astype(np.float32)
    masks = np.zeros((2, 3, 128, 128), bool)
    masks[0, 0, 10:60, 10:60] = masks[0, 1, 70:120, 30:100] = masks[1, 0, 0:90, 40:128] = True
    valid = np.array([[True, True, False], [True, False, False]])
    labels = rng.randint(0, 5, (2, 3))
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (2, 3, 2)), rng.uniform(0.1, 0.6, (2, 3, 2))],
                           -1).astype(np.float32)
    jt = JTargets(jnp.asarray(labels, jnp.int32), jnp.asarray(masks), jnp.asarray(boxes),
                  jnp.asarray(valid))
    tt = Targets(*(torch.from_numpy(a) for a in (labels, masks, boxes, valid)))
    return x, mf, jt, tt


def _replay(monkeypatch, recorded):
    monkeypatch.undo()
    recorded = [np.asarray(d) for d in recorded]
    replay_draws(monkeypatch, tdec, recorded)
    return recorded


@pytest.mark.parametrize("mode", STATIC3)
def test_static3_masks_equal_jax_bit_for_bit(monkeypatch, mode):
    """The noised 1/8 mask, its nearest-downsampled coarser levels (or
    points_MAE's per-level draws) and the invalid slot fully blocked: the
    JAX `_static3_blocked` against the port's `static3_blocked`, with
    DN_RATIO 0.5 picking which instances `scale` grows."""
    _, _, jt, tt = _inputs()
    dec = JaxMaskDN(in_channels=32, num_classes=5, dn_mode=mode, dn_ratio=0.5)
    size_list = [(s, s) for s in SIZES]
    recorded = record_jax_draws(monkeypatch, 5)
    apply = jax.jit(lambda gt: (dec.apply(
        {}, gt, jt, 2, 0.4, size_list, 2, 3, 6,
        method=JaxMaskDN._static3_blocked, rngs={"dn": jax.random.PRNGKey(3)}), list(recorded)))
    want, draws = apply(jnp.asarray(tt.masks.numpy(), jnp.float32))
    recorded = _replay(monkeypatch, draws)
    fg = tdec.resize(tt.masks.float(), (16, 16), "nearest") > 0.5
    fg = fg[:, None].expand(2, 2, 3, 16, 16).reshape(-1, 16, 16)
    boxes = tt.boxes[:, None].expand(2, 2, 3, 4).reshape(-1, 4)
    got = tdec.static3_blocked(mode, fg, boxes, 0.4, 0.5, size_list, None)
    assert not recorded
    valid = tt.valid[:, None, :, None]
    for lvl, (g, w) in enumerate(zip(got, want)):
        g = (g.view(2, 2, 3, -1) | ~valid).view(2, 6, -1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"level {lvl}")
    # the noise changed the mask somewhere: the comparison is not of the plain ground truth
    plain = ~fg.view(2, 2, 3, 256) | ~valid
    assert (got[2].view(2, 2, 3, 256) | ~valid).ne(plain).any()


def _decoder_pair(mode, head_dn, seed=0):
    """The port's decoder (seeded init) and the JAX decoder holding its
    weights through the JAX importer."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        tdecoder = tdec.MultiScaleMaskedTransformerDecoderMaskDN(
            DEC["in_channels"], num_classes=5, hidden_dim=32, num_queries=6, nheads=4,
            dim_feedforward=64, dec_layers=3, mask_dim=32, dn_mode=mode, head_dn=head_dn,
            all_lys=True, dn_ratio=0.5, dn_label_noise_ratio=0.2).eval()
    params = convert_predictor({k: v.numpy() for k, v in tdecoder.state_dict().items()}, "")
    jdecoder = JaxMaskDN(**DEC, dn_mode=mode, head_dn=head_dn, all_lys=True, dn_ratio=0.5,
                         dn_label_noise_ratio=0.2)
    return tdecoder, jdecoder, params


def _check(got, want, what):
    assert got["pred_logits"].shape == tuple(want["pred_logits"].shape), what
    assert np.abs(got["pred_logits"].detach().numpy() - np.asarray(want["pred_logits"])).max() \
        < 1e-3, what
    assert np.abs(got["pred_masks"].detach().numpy() - np.asarray(want["pred_masks"])).max() \
        < 1e-2, what


@pytest.mark.parametrize("mode,head_dn", [(m, h) for m in ("points", "lb", "mask", "base")
                                          for h in (False, True)]
                         + [(m, False) for m in STATIC3])
def test_decoder_outputs_match_jax(monkeypatch, mode, head_dn):
    """Every mode (with HEAD_DN where the JAX test matrix has it), label
    noise 0.2, ALL_LY_DN, noise scale 0.2 (0.3 for the static3 modes): the
    learnable queries' and the DN block's outputs of every layer."""
    x, mf, jt, tt = _inputs()
    tdecoder, jdecoder, params = _decoder_pair(mode, head_dn)
    noise = 0.3 if mode in STATIC3 else 0.2
    recorded = record_jax_draws(monkeypatch, 5)

    @jax.jit
    def apply(p, xs, m):
        out = jdecoder.apply({"params": p}, xs, m, JDNArgs(targets=jt, scalar=2, noise_scale=noise),
                             train=True, rngs={"dn": jax.random.PRNGKey(2)})
        return out, list(recorded)

    want, draws = apply(params, [jnp.asarray(a) for a in x], jnp.asarray(mf.transpose(0, 2, 3, 1)))
    recorded = _replay(monkeypatch, draws)
    with torch.no_grad():
        got = tdecoder([torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in x],
                       torch.from_numpy(mf), DNArgs(targets=tt, scalar=2, noise_scale=noise))
    assert not recorded, "the port drew fewer times than the JAX decoder"
    assert len(draws) > 0
    _check(got, want, "final")
    for i, (g, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        _check(g, w, f"aux {i}")
    gdn, wdn = got["dn_out"], want["dn_out"]
    assert gdn["dn_args"] == {k: int(v) for k, v in wdn["dn_args"].items()} \
        == {"max_num": 3, "pad_size": 6, "scalar": 2}
    _check(gdn, wdn, "dn final")
    for i, (g, w) in enumerate(zip(gdn["aux_outputs"], wdn["aux_outputs"])):
        _check(g, w, f"dn aux {i}")


def _dn_step(monkeypatch, mode):
    """One training step in both packages (tests/test_torch_train_step.py:
    one_step), with DN_MODE `mode`, two groups, noise scale 0.2 and label
    noise 0.2: the JAX draws of its cost pass (the loss pass draws the same
    from the same key) replayed in the port's one forward."""
    overrides = TRAIN + ["MODEL.MASK_FORMER.DN_MODE", mode, "MODEL.DN.NUM_DN", "2",
                         "MODEL.DN.NOISE_SCALE", "0.2", "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.2"]
    jcfg, jmodel, params, tcfg, tmodel, img = _build_pair(overrides, IMG)
    img = np.concatenate([img, img[:, ::-1]], 0)
    jt, tt = make_targets(n=6, counts=(3, 1))
    jcrit, tcrit = jax_build_criterion(jcfg), build_criterion(tcfg)
    rngs = {"dn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    rng_loss = jax.random.PRNGKey(3)
    num_masks = jnp.maximum(jt.valid.sum().astype(jnp.float32), 1.0)
    recorded = record_jax_draws(monkeypatch, 80)

    @jax.jit
    def cost_pass(p):
        outputs = jmodel.apply({"params": p}, jnp.asarray(img), jt, train=True, rngs=rngs)
        model_draws = list(recorded)  # the matcher's point draws come after
        return jcrit.layer_costs(outputs, jt, rng_loss)[0], model_draws

    costs, draws = cost_pass(params)
    recorded = _replay(monkeypatch, draws)
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
    assert not recorded, "the port drew fewer times than the JAX model"
    return dict(jlosses={k: float(v) for k, v in jlosses.items()}, jtotal=float(jtotal),
                jgrads=jax.tree.map(np.asarray, jgrads), model=model, metrics=metrics)


@pytest.mark.parametrize("mode", ["base", "shift_scale"])
def test_model_step_matches_jax(monkeypatch, mode):
    """`base` (mask-averaged pixel features as content, its multiplicative
    noise, no refresh: the DN rows read the predicted masks from layer 1 on)
    and `shift_scale` (a static3 mode with label flips): losses and every
    gradient. `base` leaves the label embedding unused: the port has no
    gradient there, the JAX package zeros."""
    step = _dn_step(monkeypatch, mode)
    check_losses(step)
    model = step["model"]
    want = named_gradients_from_jax(step["jgrads"], model)
    largest = max(g.abs().max().item() for g in want.values())
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            assert mode == "base" and name.endswith("label_enc.weight"), name
            assert want[name].abs().max().item() == 0.0
            continue
        scale = max(want[name].abs().max().item(), 1e-4 * largest)
        err = (p.grad - want[name]).abs().max().item() / scale
        assert err <= 1e-3, (name, err)


def test_dn_query_recipe_with_the_maskdn_decoder_steps_in_mode_base(tmp_path):
    """`maskformer2_R50_bs16_12ep_DN_query.yaml` with the decoder `eval.sh`
    names and nothing else about DN: MODEL.MASK_FORMER.DN_MODE is the
    default `base`, NUM_DN 5 and NOISE_SCALE 0.2 come from the recipe, and a
    `Trainer` step on the CPU (narrow widths) gives finite losses with the
    DN block's terms."""
    from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg

    cfg = _cfg(get_cfg, add_deeplab_config, add_maskformer2_config,
               SMALL + ["MODEL.SEM_SEG_HEAD.NUM_CLASSES", "4", "SOLVER.IMS_PER_BATCH", "2",
                        "SOLVER.MAX_ITER", "1", "OUTPUT_DIR", str(tmp_path),
                        "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64"])
    assert (cfg.MODEL.MASK_FORMER.DN_MODE, cfg.MODEL.DN.NUM_DN, cfg.MODEL.DN.NOISE_SCALE) \
        == ("base", 5, 0.2)
    trainer = Trainer(cfg, synthetic_batches(2, 64, 4, 5, seed=0), device="cpu")
    assert trainer.model.training
    metrics = trainer.run_step(next(synthetic_batches(2, 64, 4, 5, seed=0)))
    assert {"loss_ce_dn", "loss_mask_dn", "loss_dice_dn"} <= set(metrics)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["loss_mask_dn"]) > 0
