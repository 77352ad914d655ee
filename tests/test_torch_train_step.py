"""Slice 3 as a whole: one training step of the port against the JAX package,
at a small size (the released training recipe's settings: DN `points`, NUM_DN
1, noise scale 0, ALL_LY_DN; R50 depth at narrow widths, hidden 32, 4 heads, 8
queries, 64 px, 256 points).

The same parameters go through the converter into the port; both packages get
the same batch and the same assignments (the JAX package's own, from its cost
pass and its host solver, as its two-phase `TPU.MATCHER_HOST_EXACT` step does).
The settings leave nothing to draw: noise scale 0, no label flips, and an
importance ratio of 1.0, under which the `grid` point loss takes no random
extras. Gradient clipping is off in the comparison of the step, because the
two packages clip by different norms when part of the model is frozen (the JAX
package counts the gradients of frozen parameters, the port and the reference
do not have them); `tests/test_torch_optimizer.py` shows the clipped update on
equal gradient sets.

Tolerances, float32 on both sides: losses 1e-4 relative; each gradient within
1e-3 of its parameter's largest gradient entry;
parameters after the AdamW step: the first Adam update is LR * sign(g) where
|g| is above eps, so an entry whose gradient is within rounding of 0 can move
the other way: every entry within 2.5 LR of the JAX one, and every entry whose
gradient is clear of rounding noise (above 1e-3 of its parameter's largest)
within 2% of the LR.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mp_former_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
from mp_former_tpu.models.criterion import build_criterion as jax_build_criterion
from mp_former_tpu.models.matcher import _lsa_host

from mp_former_tpu_torch.data.synthetic import synthetic_batches
from mp_former_tpu_torch.engine.convert import (named_gradients_from_jax,
                                                state_dict_from_jax_params)
from mp_former_tpu_torch.engine.optimizer import build_gradient_clipper, build_optimizer
from mp_former_tpu_torch.engine.train_step import train_step
from mp_former_tpu_torch.engine.trainer import Trainer
from mp_former_tpu_torch.models.criterion import build_criterion
from mp_former_tpu_torch.structures import Batch

from test_torch_dn_decoder import DN, IMG, make_targets
from test_torch_slice import SMALL, _build_pair

torch.set_num_threads(2)

LR = 1e-3
TRAIN = SMALL + DN + [
    "MODEL.DN.NUM_DN", "1", "MODEL.DN.NOISE_SCALE", "0.0",
    "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.0", "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256",
    "MODEL.MASK_FORMER.IMPORTANCE_SAMPLE_RATIO", "1.0", "TPU.DN_MAX_GT", "4",
    "SOLVER.BASE_LR", str(LR), "SOLVER.CLIP_GRADIENTS.ENABLED", "False",
    "SOLVER.LR_SCHEDULER_NAME", "WarmupMultiStepLR",
    # the recipe freezes nothing but the FrozenBN statistics; d2's default of 2
    # (stem and res2) puts the freezing rule into the comparison
    "MODEL.BACKBONE.FREEZE_AT", "2",
]


@pytest.fixture(scope="module")
def step():
    """One step in both packages; everything the tests compare."""
    jcfg, jmodel, params, tcfg, tmodel, img = _build_pair(TRAIN, IMG)
    assert jcfg.MODEL.BACKBONE.FREEZE_AT == 2 and jcfg.TPU.POINT_SAMPLE_MODE == "grid"
    img = np.concatenate([img, img[:, ::-1]], 0)
    jt, tt = make_targets(n=6, counts=(3, 1))
    jcrit, tcrit = jax_build_criterion(jcfg), build_criterion(tcfg)
    rngs = {"dn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    rng_loss = jax.random.PRNGKey(3)
    num_masks = jnp.maximum(jt.valid.sum().astype(jnp.float32), 1.0)

    # the JAX package's cost pass and host solver (engine/train_step.py:make_cost_step)
    outputs = jmodel.apply({"params": params}, jnp.asarray(img), jt, train=True, rngs=rngs)
    costs, _ = jcrit.layer_costs(outputs, jt, rng_loss)
    l, b, q, n = costs.shape
    assignments = _lsa_host(np.asarray(costs).reshape(l * b, q, n)).reshape(l, b, n)

    def loss_fn(p):  # engine/train_step.py:128-137
        out = jmodel.apply({"params": p}, jnp.asarray(img), jt, train=True, rngs=rngs)
        losses = jcrit(out, jt, rng_loss, num_masks=num_masks,
                       assignments=jnp.asarray(assignments))
        return jcrit.weighted_total(losses), losses

    (jtotal, jlosses), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tx = jax_build_optimizer(jcfg, params)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    model = copy.deepcopy(tmodel)
    optimizer, scheduler = build_optimizer(tcfg, model)
    tcrit.assign = lambda costs: torch.from_numpy(assignments.astype(np.int64))
    batch = Batch(torch.from_numpy(img), tt)
    metrics = train_step(model, tcrit, optimizer, scheduler, batch,
                         torch.Generator().manual_seed(0),
                         clip_gradients=build_gradient_clipper(tcfg))
    return dict(jlosses={k: float(v) for k, v in jlosses.items()}, jtotal=float(jtotal),
                jgrads=jax.tree.map(np.asarray, jgrads), jnew=jax.tree.map(np.asarray, jnew),
                params=params, model=model, start=tmodel, metrics=metrics, tcfg=tcfg,
                batch=batch)


def test_loss_dict_matches_jax(step):
    metrics, want = step["metrics"], step["jlosses"]
    assert set(metrics) == set(want) | {"total_loss"}
    assert len(want) == 24  # 3 aux layers + final, main and DN, ce / mask / dice
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
        assert v > 0, k  # the DN losses too: the DN block is live
    np.testing.assert_allclose(metrics["total_loss"].item(), step["jtotal"], rtol=1e-4)


def test_gradients_match_jax_leaf_by_leaf(step):
    model = step["model"]
    want = named_gradients_from_jax(step["jgrads"], model)
    largest = max(g.abs().max().item() for g in want.values())
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and name.startswith(("backbone.stem", "backbone.res2")), name
            continue
        assert p.grad is not None, name
        # a gradient that is 0 in exact arithmetic (a conv bias in front of a
        # GroupNorm with one channel a group, the key bias of an attention) is
        # rounding noise in both packages: the floor keeps it out
        scale = max(want[name].abs().max().item(), 1e-4 * largest)
        err = (p.grad - want[name]).abs().max().item() / scale
        assert err <= 1e-3, (name, err)
        checked += 1
    # every layer of the slice has a parameter in the comparison, the two with
    # kernels among them: deformable attention and masked cross-attention
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    for part in ("backbone.res5", "pixel_decoder.transformer.encoder.layers.0.self_attn."
                 "sampling_offsets", "self_attn.value_proj", "multihead_attn.in_proj_weight",
                 "transformer_self_attention_layers", "label_enc", "query_feat", "mask_embed"):
        assert any(part in n for n in names), part
    assert checked == len(names) > 100


def test_parameters_after_one_step_match_jax(step):
    model, start = step["model"], step["start"].state_dict()
    want = state_dict_from_jax_params(step["jnew"])
    grads = named_gradients_from_jax(step["jgrads"], model)
    largest = max(g.abs().max().item() for g in grads.values())
    moved, clear, entries = 0, 0, 0
    for name, v in model.state_dict().items():
        diff = (v - want[name]).abs()
        mult = 0.1 if name.startswith("backbone.") else 1.0
        assert diff.max().item() <= 2.5 * LR * mult, name
        if name in grads:
            # where the gradient is clear of rounding noise the update is the same
            sure = grads[name].abs() > max(1e-3 * grads[name].abs().max().item(), 1e-4 * largest)
            assert diff[sure].max().item() <= 0.02 * LR * mult if sure.any() else True, name
            clear, entries = clear + int(sure.sum()), entries + sure.numel()
        moved += int((v != start[name]).any())
    assert clear > 0.5 * entries
    frozen = [n for n in start if n.startswith(("backbone.stem", "backbone.res2"))
              or "running_" in n or ".norm." in n and n.startswith("backbone.")]
    for n in frozen:
        torch.testing.assert_close(model.state_dict()[n], start[n], rtol=0, atol=0, msg=n)
    assert moved > 100


def test_clipped_step_follows_the_reference_norm(step):
    """With clipping on, the port clips by the norm of the parameters that
    train. That is optax's clipped update when the gradients of the frozen
    leaves are left out of its norm."""
    tcfg = step["tcfg"].clone()
    tcfg.merge_from_list(["SOLVER.CLIP_GRADIENTS.ENABLED", "True"])
    model = copy.deepcopy(step["start"])
    optimizer, scheduler = build_optimizer(tcfg, model)
    named = named_gradients_from_jax(step["jgrads"], model)
    for n, p in model.named_parameters():
        if p.requires_grad:
            p.grad = named[n].clone()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    norm = torch.sqrt(sum((p.grad ** 2).sum() for p in params))
    build_gradient_clipper(tcfg)(params)
    clip = tcfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE
    assert norm > clip == 0.01
    for n, p in model.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(p.grad, named[n] * (clip / norm), rtol=1e-5, atol=0)


def test_trainer_runs_saves_and_resumes_on_the_cpu(step, tmp_path):
    cfg = step["tcfg"].clone()
    cfg.merge_from_list(["SOLVER.MAX_ITER", "3", "SOLVER.CHECKPOINT_PERIOD", "2",
                         "OUTPUT_DIR", str(tmp_path), "SEED", "5",
                         "MODEL.MASK_FORMER.IMPORTANCE_SAMPLE_RATIO", "0.75",
                         "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.2"])
    batches = lambda: synthetic_batches(2, 64, 80, 5, seed=1)  # noqa: E731
    trainer = Trainer(cfg, batches(), model=copy.deepcopy(step["start"]), device="cpu")
    trainer.train()
    import json
    lines = [json.loads(x) for x in (tmp_path / "metrics.json").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [0, 2]
    assert all(np.isfinite(v) for x in lines for v in x.values())
    assert {"total_loss", "loss_ce", "loss_mask_dn_2", "loss_dice_1", "lr"} <= set(lines[0])
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "last_checkpoint", "model_0000002.pth", "model_0000003.pth"]
    resumed = Trainer(cfg, batches(), model=copy.deepcopy(step["start"]), device="cpu")
    assert resumed.resume_or_load() == 3
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    assert resumed.scheduler.last_epoch == 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (this machine has one: nothing to show)")
        Trainer(cfg, batches(), device="cuda")
