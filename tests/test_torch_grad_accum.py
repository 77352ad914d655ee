"""`TPU.GRAD_ACCUM_STEPS` in the port against the JAX package's accumulation,
at the small size of `tests/test_torch_train_step.py` (the released training
recipe's settings, settings that leave nothing to draw), B = 4, accum 2.

The JAX side is the formula that `tests/test_grad_accum.py` writes out for
the JAX package's scanned step (`mp_former_tpu/engine/train_step.py:141-196`):
the strided micro-batch split, each micro-batch's criterion normalised by the
whole batch's num_masks, the `loss_ce*` terms divided by accum before the
weighted total, gradients summed, one AdamW update; with the JAX package's
host-exact assignments (its cost pass and scipy) per micro-batch, which the
port's matcher is handed. Tolerances as in `tests/test_torch_train_step.py`:
losses 1e-4 relative, gradients 1e-3 of each parameter's largest entry,
parameters after the update by its rule.
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

from mp_former_tpu_torch.engine.optimizer import build_gradient_clipper, build_optimizer
from mp_former_tpu_torch.engine.train_step import compute_dn_groups, micro_batches, train_step
from mp_former_tpu_torch.engine.trainer import Trainer
from mp_former_tpu_torch.models.criterion import build_criterion
from mp_former_tpu_torch.structures import Batch

from test_torch_dn_decoder import IMG, make_targets
from test_torch_slice import CONFIG, _build_pair
from test_torch_train_step import TRAIN, check_gradients, check_losses, check_parameters

torch.set_num_threads(2)

ACCUM = 2
# rows 0, 2 (micro-batch 0) hold 3 and 2 instances, rows 1, 3 (micro-batch 1) 1 and 2
COUNTS = (3, 1, 2, 2)


def _images(img):
    return np.ascontiguousarray(np.concatenate(
        [img, img[:, ::-1], img[:, :, ::-1], img[:, ::-1, ::-1]], 0))


def _strided(x, k):
    """Micro-batch k of the JAX package's split (`train_step.py:148-154`)."""
    b = x.shape[0]
    return x.reshape((b // ACCUM, ACCUM) + x.shape[1:])[:, k]


def accumulated_step():
    jcfg, jmodel, params, tcfg, tmodel, img = _build_pair(TRAIN, IMG, CONFIG, 0)
    images = _images(img)
    jt, tt = make_targets(b=4, n=6, counts=COUNTS)
    jcrit, tcrit = jax_build_criterion(jcfg), build_criterion(tcfg)
    rngs = {"dn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    rng_loss = jax.random.PRNGKey(3)
    num_masks = jnp.maximum(jt.valid.sum().astype(jnp.float32), 1.0)

    @jax.jit
    def cost_pass(p, x, t):
        outputs = jmodel.apply({"params": p}, x, t, train=True, rngs=rngs)
        return jcrit.layer_costs(outputs, t, rng_loss)[0]

    def micro_loss(p, x, t, assignments):  # tests/test_grad_accum.py:micro_loss
        out = jmodel.apply({"params": p}, x, t, train=True, rngs=rngs)
        losses = jcrit(out, t, rng_loss, num_masks=num_masks, assignments=assignments)
        scaled = {k: v / ACCUM if k.startswith("loss_ce") else v for k, v in losses.items()}
        return jcrit.weighted_total(scaled), losses

    grad_fn = jax.jit(jax.value_and_grad(micro_loss, has_aux=True))
    jtotal, jgrads, jsums, assignments = 0.0, None, None, []
    for k in range(ACCUM):
        x = jnp.asarray(_strided(images, k))
        t = jax.tree.map(lambda a: _strided(a, k), jt)
        costs = np.asarray(cost_pass(params, x, t))
        l, b, q, n = costs.shape
        assignments.append(_lsa_host(costs.reshape(l * b, q, n)).reshape(l, b, n))
        (total, losses), g = grad_fn(params, x, t, jnp.asarray(assignments[-1]))
        jtotal += float(total)
        jgrads = g if jgrads is None else jax.tree.map(jnp.add, jgrads, g)
        jsums = losses if jsums is None else jax.tree.map(jnp.add, jsums, losses)
    jlosses = {k: float(v) / ACCUM if k.startswith("loss_ce") else float(v)
               for k, v in jsums.items()}
    tx = jax_build_optimizer(jcfg, params)

    @jax.jit
    def update(grads, p):
        updates, _ = tx.update(grads, tx.init(p), p)
        return optax.apply_updates(p, updates)

    jnew = update(jgrads, params)

    model = copy.deepcopy(tmodel)
    optimizer, scheduler = build_optimizer(tcfg, model)
    handed = iter(assignments)
    tcrit.assign = lambda costs: torch.from_numpy(next(handed).astype(np.int64))
    batch = Batch(torch.from_numpy(images), tt)
    metrics = train_step(model, tcrit, optimizer, scheduler, batch,
                         torch.Generator().manual_seed(0),
                         clip_gradients=build_gradient_clipper(tcfg), accum=ACCUM)
    assert next(handed, None) is None  # one matcher call a micro-batch
    return dict(jlosses=jlosses, jtotal=jtotal, jgrads=jax.tree.map(np.asarray, jgrads),
                jnew=jax.tree.map(np.asarray, jnew), params=params, model=model, start=tmodel,
                metrics=metrics, tcfg=tcfg, batch=batch, assignments=assignments)


@pytest.fixture(scope="module")
def step():
    return accumulated_step()


def test_accumulated_losses_match_the_jax_formula(step):
    check_losses(step)


def test_accumulated_gradients_match_the_jax_formula_leaf_by_leaf(step):
    check_gradients(step)


def test_parameters_after_the_accumulated_step_match_the_jax_formula(step):
    check_parameters(step)


def test_accumulation_against_the_monolithic_step(step):
    """The same batch in one step, with the same assignments: the mask and
    dice terms (normalised by the whole batch's num_masks) sum to the
    monolithic ones within 1e-4; the CE terms, means over each micro-batch,
    average to the monolithic mean only where the micro-batches carry equal
    no-object weight, which here they do not."""
    tcfg = step["tcfg"]
    model = copy.deepcopy(step["start"])
    optimizer, scheduler = build_optimizer(tcfg, model)
    crit = build_criterion(tcfg)
    a0, a1 = step["assignments"]
    whole = np.stack([a0[:, 0], a1[:, 0], a0[:, 1], a1[:, 1]], 1)  # back to batch order
    crit.assign = lambda costs: torch.from_numpy(whole.astype(np.int64))
    mono = train_step(model, crit, optimizer, scheduler, step["batch"],
                      torch.Generator().manual_seed(0))
    acc = step["metrics"]
    assert set(mono) == set(acc)
    for k, v in mono.items():
        if k.startswith(("loss_mask", "loss_dice")):
            np.testing.assert_allclose(acc[k].item(), v.item(), rtol=1e-4, atol=1e-7, err_msg=k)
    ce = [k for k in mono if k.startswith("loss_ce") and abs(acc[k] - mono[k]) > 1e-4 * mono[k]]
    assert ce  # unequal no-object weight: the accumulated CE terms are another mean


def test_a_batch_that_accum_does_not_divide_raises(step, tmp_path):
    cfg = step["tcfg"].clone()
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", "6", "TPU.GRAD_ACCUM_STEPS", "4",
                         "OUTPUT_DIR", str(tmp_path)])
    with pytest.raises(ValueError, match="IMS_PER_BATCH=6 must be divisible by "
                                         "TPU.GRAD_ACCUM_STEPS=4"):
        Trainer(cfg, iter(()), model=step["start"], device="cpu")
    batch = step["batch"]
    with pytest.raises(ValueError, match="a batch of 4 images does not split into "
                                         "TPU.GRAD_ACCUM_STEPS=3"):
        next(micro_batches(batch, 3))
    parts = list(micro_batches(batch, 2))
    torch.testing.assert_close(parts[1].images, batch.images[1::2], rtol=0, atol=0)
    torch.testing.assert_close(parts[0].targets.masks, batch.targets.masks[0::2], rtol=0, atol=0)


def test_dn_groups_come_from_the_whole_batch(step):
    """NUM_DN >= 100: the group count divides the DN budget by the largest
    instance count of the whole batch (3), also for micro-batch 1, whose own
    largest count is 2."""
    tcfg = step["tcfg"].clone()
    tcfg.merge_from_list(["MODEL.DN.NUM_DN", "100"])
    model = copy.deepcopy(step["start"])
    model.scalar = 100
    optimizer, scheduler = build_optimizer(tcfg, model)
    seen = []
    forward = model.forward

    def spy(images, targets, dn_groups=None, generator=None):
        seen.append((dn_groups, int(targets.valid.sum(-1).max())))
        return forward(images, targets, dn_groups=dn_groups, generator=generator)

    model.forward = spy
    batch = step["batch"]
    metrics = train_step(model, build_criterion(tcfg), optimizer, scheduler, batch,
                         torch.Generator().manual_seed(0), accum=ACCUM)
    want = compute_dn_groups(100, batch.targets.valid)
    assert want == (33, 3)
    assert seen == [(want, 3), (want, 2)]
    assert all(torch.isfinite(v) for v in metrics.values())
