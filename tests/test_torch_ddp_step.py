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

The runs held against the JAX step take the JAX forward's ReLU decisions
(`HeldRelu`). At these random weights a ReLU input can sit within rounding
of 0: the pixel decoder's FPN `layer_1` has one at -3.9e-06 in the port and
+2.9e-07 in the JAX package where XLA, MKL and oneDNN are held to AVX2. The
two packages then pass the gradient through that pixel or not, which moved
`layer_1.weight`'s gradient by 1.6e-02 of its largest entry. Every decision
the port would take otherwise must sit within `RELU_FLIP_MARGIN` of 0, so
holding them cannot hide a fault larger than the forwards' own error.
"""

import functools
import os
import threading
from unittest import mock

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
# the port's forwards differ from the JAX forward, and from each other on
# other batchings, by ~1e-5 on entries of unit scale; a ReLU decision taken
# otherwise than the held one must sit within this of 0
RELU_FLIP_MARGIN = 1e-4


class HeldRelu:
    """Every ReLU of the port's model (`F.relu`, `F.relu_` and the FPN's
    conv activations), recorded or held. Without `kept` the decisions
    (input > 0) are recorded in call order into `taken`. With `kept` (the
    decisions of one forward in call order, batch first: the JAX forward's,
    or a one-process run's through `whole_batch`) each ReLU is x times the
    kept decision, whose derivative is then the held run's; the forwards
    take the rows of `rows` in turn (a slice a micro-batch). A call past the
    last forward's (the encoder's recompute under remat, which the JAX
    forward does not record) takes the kept decision of its shape that it
    agrees with most. `flips` counts the decisions the port would take
    otherwise, `margin` is the largest |input| among them."""

    def __init__(self, kept=None, rows=(slice(None),)):
        self.kept, self.rows, self.taken = kept, list(rows), []
        self.forward, self.next, self.flips, self.margin = 0, 0, 0, 0.0

    def _decision(self, x):
        took = x.detach() > 0
        if self.kept is None:
            self.taken.append(took)
            return took.to(x.dtype)
        if self.next == len(self.kept) and self.forward + 1 < len(self.rows):
            self.forward, self.next = self.forward + 1, 0
        rows = self.rows[self.forward]
        if self.next < len(self.kept):
            keep = self.kept[self.next][rows]
            self.next += 1
        else:
            same = [k[rows] for k in self.kept if k[rows].shape == x.shape]
            keep = min(same, key=lambda k: int((took != k).sum())) if same else None
        assert keep is not None and keep.shape == x.shape, (
            f"ReLU call {self.next} of shape {tuple(x.shape)}: the held one's is "
            f"{None if keep is None else tuple(keep.shape)}")
        differ = took != keep
        if differ.any():
            self.flips += int(differ.sum())
            self.margin = max(self.margin, x.detach()[differ].abs().max().item())
        return keep.to(x.dtype)

    def _relu(self, x, inplace=False):
        keep = self._decision(x)
        return x.mul_(keep) if inplace else x * keep

    def _relu_(self, x):
        return x.mul_(self._decision(x))

    def held(self, model):
        """A context in which `model`'s ReLUs go through this object."""
        import contextlib

        import torch.nn.functional as F

        stack = contextlib.ExitStack()
        for m in model.modules():
            if getattr(m, "activation", None) is F.relu:
                stack.enter_context(mock.patch.object(m, "activation", self._relu))
        stack.enter_context(mock.patch.object(F, "relu", self._relu))
        stack.enter_context(mock.patch.object(F, "relu_", self._relu_))
        return stack


def whole_batch(taken, accum: int):
    """A one-process run's recorded decisions, `accum` forwards of equal call
    counts over the strided micro-batches (`engine/train_step.py:
    micro_batches`: micro-batch k holds rows k, k + accum, ...), as the
    decisions of one forward of the whole batch in its row order."""
    n = len(taken) // accum
    assert n * accum == len(taken)
    return [torch.stack(taken[i::n], 1).flatten(0, 1) for i in range(n)]


def jax_relu_decisions(jmodel, params, images, targets, rngs):
    """The decisions (input > 0) of every `nn.relu` call of the JAX model's
    training forward, in call order, in the port's layout (NHWC moved to
    NCHW)."""
    import flax.linen as fnn
    import jax

    got, order, relu = {}, [], fnn.relu

    def recording(x):
        order.append(len(order))
        jax.debug.callback(functools.partial(got.__setitem__, order[-1]), x)
        return relu(x)

    with mock.patch.object(fnn, "relu", recording):
        out = jax.jit(lambda p: jmodel.apply({"params": p}, images, targets, train=True,
                                             rngs=rngs))(params)
        jax.block_until_ready(out)
        jax.effects_barrier()
    arrays = [np.asarray(got[i]) for i in order]
    arrays = [a.transpose(0, 3, 1, 2) if a.ndim == 4 else a for a in arrays]
    return [torch.from_numpy(np.ascontiguousarray(a) > 0) for a in arrays]


def _step(cfg, weights, batch: Batch, assignments=None, relu: HeldRelu = None):
    """One `Trainer.run_step` of `batch` from `weights`; (losses, gradients
    by name, the trainer). `assignments` (L, B, N), where given, replace the
    matcher's (this process's rows); `relu`, where given, holds the ReLU
    decisions."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg)
    model.load_state_dict(weights)
    trainer = Trainer(cfg, iter(()), model=model, device="cpu")
    if assignments is not None:
        trainer.criterion.assign = lambda costs: assignments
    if relu is None:
        metrics = trainer.run_step(batch)
    else:
        with relu.held(trainer.model):
            metrics = trainer.run_step(batch)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads, trainer


def _rows(batch: Batch, rows: slice) -> Batch:
    return Batch(batch.images[rows], Targets(*(t[rows] for t in batch.targets)))


def _worker(config, overrides, weights, batch, assignments, decisions, out_dir):
    """One rank: every run of RUNS on its block of rows, each with the held
    ReLU decisions of `decisions[run]` (`no_draws`: the JAX forward's; the
    others: the one-process run's)."""
    torch.set_num_threads(1)
    rank, world = get_rank(), get_world_size()
    b = batch.images.shape[0] // world
    out = {}
    for name, opts in RUNS.items():
        cfg = build_cfg(config, overrides + opts)
        # micro-batch k: this rank's rows k, k + accum, ... (`micro_batches`)
        accum = cfg.TPU.GRAD_ACCUM_STEPS
        relu = HeldRelu(decisions[name], [slice(rank * b + k, (rank + 1) * b, accum)
                                          for k in range(accum)])
        rows = slice(rank * b, (rank + 1) * b)
        mine = assignments[:, rows] if name == "no_draws" else None
        out[name] = _step(cfg, weights, _rows(batch, rows), mine, relu)[:2]
        out[name + "_relu"] = (relu.flips, relu.margin)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX pair's weights, the batch, the JAX step's losses and
    gradients, and every run on two ranks and in one process. The
    one-process runs, then the two ranks, run while the JAX step compiles."""
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
    jimg = jnp.asarray(batch.images.numpy())
    rngs = {"dn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    decisions = {"no_draws": jax_relu_decisions(jmodel, params, jimg, jt, rngs)}
    one, failed = {}, []

    def one_process_then_two_ranks():
        """The one-process runs record their ReLU decisions (`no_draws`
        holds the JAX forward's), which the ranks then hold."""
        for name, opts in RUNS.items():
            cfg = build_cfg(CONFIG, overrides + opts)
            relu = HeldRelu(decisions.get(name))
            one[name] = _step(cfg, weights, batch, assignments if name == "no_draws" else None,
                              relu)
            one[name + "_relu"] = (relu.flips, relu.margin)
            if name != "no_draws":
                decisions[name] = whole_batch(relu.taken, cfg.TPU.GRAD_ACCUM_STEPS)
        launch(_worker, 2, backend="gloo",
               args=(CONFIG, overrides, weights, batch, assignments, decisions, str(out_dir)))

    def catching(run):
        try:
            run()
        except Exception as e:  # raised in the test's thread below
            failed.append(e)

    thread = threading.Thread(target=catching, args=(one_process_then_two_ranks,))
    thread.start()
    jcrit = jax_build_criterion(jcfg)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jimg, jt, train=True, rngs=rngs)
        losses = jcrit(out, jt, jax.random.PRNGKey(3), num_masks=jnp.maximum(
            jt.valid.sum(), 1.0).astype(jnp.float32), assignments=jnp.asarray(assignments.numpy()))
        return jcrit.weighted_total(losses), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    thread.join()
    if failed:
        raise failed[0]
    ranks = [torch.load(out_dir / f"rank{r}.pt") for r in range(2)]
    return dict(ranks=ranks, one=one, jlosses={k: float(v) for k, v in jlosses.items()},
                jgrads=jax.tree.map(np.asarray, jgrads), tmodel=tmodel, batch=batch,
                config=CONFIG, overrides=overrides)


def _check(losses, grads, want_losses, want_grads, loss_tol, grad_tol):
    """Every loss within `loss_tol` relative (and 1e-7 absolute), every
    gradient within `grad_tol` of its parameter's largest entry (at least
    1e-4 of the largest entry of all). A failure lists every loss's error
    and the worst gradients with theirs."""
    assert set(losses) == set(want_losses) | ({"total_loss"} - set(want_losses))
    assert set(grads) == set(want_grads)
    loss_err = {k: abs(losses[k] - v) - 1e-7 - loss_tol * abs(v) for k, v in want_losses.items()}
    largest = max(g.abs().max().item() for g in want_grads.values())
    grad_err = {name: (grads[name] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-4 * largest) for name, g in want_grads.items()}
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    report = ("losses (got, want): " + ", ".join(
        f"{k} {losses[k]:.8g} {v:.8g}" for k, v in sorted(want_losses.items()))
        + f"; worst gradients (error / tolerance {grad_tol:g}): "
        + ", ".join(f"{n} {e:.3g}" for n, e in worst))
    assert max(loss_err.values()) <= 0 and worst[0][1] <= grad_tol, report


def _check_relu(flips_margin):
    flips, margin = flips_margin
    assert margin <= RELU_FLIP_MARGIN, (
        f"{flips} ReLU decisions taken otherwise than the held ones, the largest "
        f"|input| {margin:.3g} > {RELU_FLIP_MARGIN:g}")


@pytest.mark.parametrize("run", ["draws", "draws_accum2", "random_capped"])
def test_two_rank_step_equals_the_one_process_step(runs, run):
    """Losses averaged over the ranks and the all-reduced gradients equal the
    one-process step's on the 4 images, every random draw included; both
    ranks hold the same gradients."""
    one_losses, one_grads, _ = runs["one"][run]
    for rank in runs["ranks"]:
        _check_relu(rank[run + "_relu"])
        _check(*rank[run], one_losses, one_grads, 1e-5, 1e-4)
    assert one_losses["loss_ce_dn"] > 0 and one_losses["loss_mask"] > 0


def test_two_rank_step_equals_the_jax_step(runs):
    """Without draws and with the JAX package's assignments, the two-rank
    step is the JAX step on the 4 images: its losses and gradients."""
    from mp_former_tpu_torch.engine.convert import named_gradients_from_jax

    want = named_gradients_from_jax(runs["jgrads"], runs["tmodel"])
    for rank in runs["ranks"]:
        losses, grads = rank["no_draws"]
        _check_relu(rank["no_draws_relu"])
        # FREEZE_AT 2: the stem and res2 train in neither package's comparison
        assert all(n.startswith(("backbone.stem", "backbone.res2")) for n in set(want) - set(grads))
        _check(losses, grads, runs["jlosses"], {n: want[n] for n in grads}, 1e-4, 1e-3)


def test_one_process_step_equals_the_jax_step(runs):
    """The same on the 4 images in one process: what the two-rank test
    finds, this one says whether it belongs to the distributed path or to
    the port's step."""
    from mp_former_tpu_torch.engine.convert import named_gradients_from_jax

    want = named_gradients_from_jax(runs["jgrads"], runs["tmodel"])
    losses, grads, _ = runs["one"]["no_draws"]
    _check_relu(runs["one"]["no_draws_relu"])
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
