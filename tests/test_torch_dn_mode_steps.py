"""Model-level training steps of the DN modes against the JAX package: one
step of `base` and of `shift_scale` (losses 1e-4 relative, gradients 1e-3 of
each parameter's largest entry) through tests/test_torch_slice.py:_build_pair,
the JAX draws replayed in the port's one forward
(tests/test_torch_dn_modes.py), and the DN_query recipe's `Trainer` step in
mode `base`. Six tests at most a file: the Tier-1 run queues such files
behind its longest one (ROADMAP.md, "Tier-1's clock").
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.models.criterion import build_criterion as jax_build_criterion
from mp_former_tpu.models.matcher import _lsa_host

from mp_former_tpu_torch.data.synthetic import synthetic_batches
from mp_former_tpu_torch.engine.convert import named_gradients_from_jax
from mp_former_tpu_torch.engine.optimizer import build_optimizer
from mp_former_tpu_torch.engine.train_step import train_step
from mp_former_tpu_torch.engine.trainer import Trainer
from mp_former_tpu_torch.models.criterion import build_criterion
from mp_former_tpu_torch.structures import Batch

from test_torch_dn_decoder import IMG, make_targets, record_jax_draws
from test_torch_dn_modes import _replay
from test_torch_slice import SMALL, _build_pair, _cfg
from test_torch_train_step import TRAIN, check_losses

torch.set_num_threads(2)


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
