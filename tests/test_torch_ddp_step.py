"""A data-parallel training step (`parallel/`, `engine/train_step.py` under
DDP) against the one-process step on the union batch and the JAX package's
step, at the small size of `tests/test_torch_train_step.py`.

Two gloo processes (`parallel/dist.py:launch`, one thread each) each take 2
images of a batch of 4 whose ranks hold 4 and 2 instances, and run one
`Trainer.run_step` from the same weights: with the released DN settings and
their draws (label noise 0.2, the grid loss's random extras) at
GRAD_ACCUM_STEPS 1 and 2; with the random-point loss and a pair cap that
leaves rank 1 no pair (TPU.MAX_PAIRS 4 of 6); and without draws, with the
JAX package's assignments, against the JAX step. The one-process runs are
the same `Trainer.run_step` on all 4 images.

Tolerances (float32): against the one-process step, losses 1e-5 relative and
the all-reduced gradients 1e-4 of each parameter's largest entry (the ranks'
sums and DDP's average add in another order); against the JAX step, those
of `tests/test_torch_train_step.py`, losses 1e-4 and gradients 1e-3.
"""

import os
import threading

import numpy as np
import pytest
import torch

from mp_former_tpu_torch.config import build_cfg
from mp_former_tpu_torch.engine.trainer import Trainer
from mp_former_tpu_torch.models import build_model
from mp_former_tpu_torch.parallel.dist import get_rank, get_world_size, launch
from mp_former_tpu_torch.structures import Batch, Targets

torch.set_num_threads(2)

# 2 + 2 images; rank 0 holds 3 + 1 instances, rank 1 2 + 0
COUNTS = (3, 1, 2, 0)
DRAWS = ["MODEL.DN.NUM_DN", "1", "MODEL.DN.NOISE_SCALE", "0.0",
         "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.2", "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256",
         "SOLVER.CLIP_GRADIENTS.ENABLED", "False", "SOLVER.IMS_PER_BATCH", "4",
         "MODEL.BACKBONE.FREEZE_AT", "2", "MODEL.DEVICE", "cpu"]
RUNS = {
    "draws": DRAWS,
    "draws_accum2": DRAWS + ["TPU.GRAD_ACCUM_STEPS", "2"],
    # the cap keeps rank 0's 4 pairs and none of rank 1's, which draws all the same
    "random_capped": DRAWS + ["TPU.POINT_SAMPLE_MODE", "random", "TPU.MAX_PAIRS", "4"],
    # nothing to draw: held against the JAX step
    "no_draws": DRAWS + ["MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.0",
                         "MODEL.MASK_FORMER.IMPORTANCE_SAMPLE_RATIO", "1.0"],
}


def _step(cfg, weights, batch: Batch, assignments=None):
    """One `Trainer.run_step` of `batch` from `weights`; (losses, gradients
    by name, the trainer). `assignments` (L, B, N), where given, replace the
    matcher's (this process's rows)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg)
    model.load_state_dict(weights)
    trainer = Trainer(cfg, iter(()), model=model, device="cpu")
    if assignments is not None:
        trainer.criterion.assign = lambda costs: assignments
    metrics = trainer.run_step(batch)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads, trainer


def _rows(batch: Batch, rows: slice) -> Batch:
    return Batch(batch.images[rows], Targets(*(t[rows] for t in batch.targets)))


def _worker(config, overrides, weights, batch, assignments, out_dir):
    """One rank: every run of RUNS on its block of rows."""
    torch.set_num_threads(1)
    rank, world = get_rank(), get_world_size()
    b = batch.images.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for name, opts in RUNS.items():
        cfg = build_cfg(config, overrides + opts)
        mine = assignments[:, rows] if name == "no_draws" else None
        out[name] = _step(cfg, weights, _rows(batch, rows), mine)[:2]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX pair's weights, the batch, the JAX step's losses and
    gradients, and every run on two ranks and in one process. The two ranks
    and the one-process runs run while the JAX step compiles."""
    import jax
    import jax.numpy as jnp

    from mp_former_tpu.models.criterion import build_criterion as jax_build_criterion
    from mp_former_tpu_torch.models.criterion import build_criterion
    from test_torch_dn_decoder import IMG, make_targets
    from test_torch_slice import CONFIG, SMALL, _build_pair

    overrides = SMALL + ["MODEL.MASK_FORMER.DN_MODE", "points", "MODEL.MASK_FORMER.ALL_LY_DN",
                         "True", "MODEL.MASK_FORMER.NHEADS", "4",
                         "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
                         "MODEL.MASK_FORMER.DEC_LAYERS", "2"]
    jcfg, jmodel, params, tcfg, tmodel, _ = _build_pair(overrides + RUNS["no_draws"], IMG)
    jt, tt = make_targets(b=4, n=6, counts=COUNTS)
    rng = np.random.RandomState(1)
    batch = Batch(torch.from_numpy((rng.rand(4, *IMG, 3) * 255).astype(np.float32)), tt)
    weights = tmodel.state_dict()
    # the assignments both packages are handed: the port's matcher on the
    # whole batch (nothing is drawn in this run)
    crit = build_criterion(tcfg)
    with torch.no_grad():
        out = tmodel.train()(batch.images, tt, generator=torch.Generator().manual_seed(0))
        assignments = crit.assign(crit.layer_costs(out, tt))
    out_dir = tmp_path_factory.mktemp("ddp")
    one, failed = {}, []

    def two_ranks():
        launch(_worker, 2, backend="gloo",
               args=(CONFIG, overrides, weights, batch, assignments, str(out_dir)))

    def one_process():
        for name, opts in RUNS.items():
            one[name] = _step(build_cfg(CONFIG, overrides + opts), weights, batch,
                              assignments if name == "no_draws" else None)

    def catching(run):
        try:
            run()
        except Exception as e:  # raised in the test's thread below
            failed.append(e)

    threads = [threading.Thread(target=catching, args=(run,)) for run in (two_ranks, one_process)]
    for t in threads:
        t.start()
    jimg = jnp.asarray(batch.images.numpy())
    jcrit = jax_build_criterion(jcfg)
    rngs = {"dn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jimg, jt, train=True, rngs=rngs)
        losses = jcrit(out, jt, jax.random.PRNGKey(3), num_masks=jnp.maximum(
            jt.valid.sum(), 1.0).astype(jnp.float32), assignments=jnp.asarray(assignments.numpy()))
        return jcrit.weighted_total(losses), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    for t in threads:
        t.join()
    if failed:
        raise failed[0]
    ranks = [torch.load(out_dir / f"rank{r}.pt") for r in range(2)]
    return dict(ranks=ranks, one=one, jlosses={k: float(v) for k, v in jlosses.items()},
                jgrads=jax.tree.map(np.asarray, jgrads), tmodel=tmodel, batch=batch,
                config=CONFIG, overrides=overrides)


def _check(losses, grads, want_losses, want_grads, loss_tol, grad_tol):
    assert set(losses) == set(want_losses) | ({"total_loss"} - set(want_losses))
    for k, v in want_losses.items():
        np.testing.assert_allclose(losses[k], v, rtol=loss_tol, atol=1e-7, err_msg=k)
    largest = max(g.abs().max().item() for g in want_grads.values())
    assert set(grads) == set(want_grads)
    for name, g in want_grads.items():
        scale = max(g.abs().max().item(), 1e-4 * largest)
        err = (grads[name] - g).abs().max().item() / scale
        assert err <= grad_tol, (name, err)


@pytest.mark.parametrize("run", ["draws", "draws_accum2", "random_capped"])
def test_two_rank_step_equals_the_one_process_step(runs, run):
    """Losses averaged over the ranks and the all-reduced gradients equal the
    one-process step's on the 4 images, every random draw included; both
    ranks hold the same gradients."""
    one_losses, one_grads, _ = runs["one"][run]
    for losses, grads in (r[run] for r in runs["ranks"]):
        _check(losses, grads, one_losses, one_grads, 1e-5, 1e-4)
    assert one_losses["loss_ce_dn"] > 0 and one_losses["loss_mask"] > 0


def test_two_rank_step_equals_the_jax_step(runs):
    """Without draws and with the JAX package's assignments, the two-rank
    step is the JAX step on the 4 images: its losses and gradients."""
    from mp_former_tpu_torch.engine.convert import named_gradients_from_jax

    want = named_gradients_from_jax(runs["jgrads"], runs["tmodel"])
    for losses, grads in (r["no_draws"] for r in runs["ranks"]):
        # FREEZE_AT 2: the stem and res2 train in neither package's comparison
        assert all(n.startswith(("backbone.stem", "backbone.res2")) for n in set(want) - set(grads))
        _check(losses, grads, runs["jlosses"], {n: want[n] for n in grads}, 1e-4, 1e-3)


def test_the_class_weight_all_reduce_makes_the_steps_equal(runs):
    """Each rank's own weighted mean of the class loss, averaged as DDP
    averages, is not the global batch's weighted mean on this batch (the
    ranks hold 4 and 2 instances); the ranks' weighted sums over the summed
    weight sums, the step's `class_norm`, are."""
    from mp_former_tpu_torch.models.criterion import build_criterion

    cfg = build_cfg(runs["config"], runs["overrides"] + RUNS["no_draws"])
    batch, model = runs["batch"], runs["tmodel"].train()
    crit = build_criterion(cfg)
    with torch.no_grad():
        out = model(batch.images, batch.targets, generator=torch.Generator().manual_seed(0))
    qidx = crit.assign(crit.layer_costs(out, batch.targets))[-1]
    t = batch.targets
    whole = crit.loss_labels(out["pred_logits"], qidx, t.labels, t.valid)["loss_ce"]
    halves = [slice(0, 2), slice(2, 4)]
    local = [crit.loss_labels(out["pred_logits"][h], qidx[h], t.labels[h], t.valid[h])["loss_ce"]
             for h in halves]
    local_mean = sum(local) / 2
    # ten times the tolerance the two-rank steps are held to
    assert abs(local_mean - whole) > 1e-4 * whole
    # the step's class_norm: the ranks' weight sums, summed
    norm = sum(crit.class_weight_sums({"pred_logits": out["pred_logits"][h], "aux_outputs": []},
                                      _rows(batch, h).targets, qidx[None, h])[0, 0]
               for h in halves)
    averaged = sum(crit.loss_labels(out["pred_logits"][h], qidx[h], t.labels[h], t.valid[h],
                                    norm=norm / 2)["loss_ce"] for h in halves) / 2
    torch.testing.assert_close(averaged, whole, rtol=1e-6, atol=0)
