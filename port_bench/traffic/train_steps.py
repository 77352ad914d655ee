"""Training steps through the port's `Trainer.run_step`, one after another,
on a pool of seeded batches pinned on the host, each copied to the card by
the step as the port's loader's batches are.

Set-up builds the trainer with the benchmark's seeded weights and runs one
step on each batch of the pool (every shape the window uses): the first
`checked` of them are the steps the reference follows. The window then
steps on through the pool for `--seconds`. Its end-to-end metrics:
`train_images_per_s`, every image of every step over the whole window, the
last step's end included; `peak_gib`, the allocator's peak over the window;
`setup_s`, from the process's start to the window's.

`correct` (once the window has closed and the trainer is freed): the
reference (`reference/`, float32 with TF32 off, the same weights, batches
and generator seed) runs the checked steps. The numbers worked out: the
relative gap of step 1's total loss (`first_loss_gap`), the median over
step 1's loss terms of their relative gaps (`first_terms_gap_median`), and
the worst of the later checked steps' total (`later_loss_gap`); the worst leaf's gap between the
norms of the first gradient as AdamW got it, read from its first moment
after one step (`first_grad_gap`); the worst leaf's gap between the norms
of the parameters' change over the checked steps (`change_gap`), leaving
out the leaves whose reference gradient is under a thousandth of the median
leaf's; and the median leaf's gap of each of the last two. A leaf's gap is
measured against the larger of its reference norm and the median leaf's.
The numbers that the cell's `limits` name are compared. A window step whose
total loss is not finite counts as failed."""

from __future__ import annotations

import json
import math
import statistics
from typing import Dict

import torch

from .. import common, data
from ..spec import Check, Outcome

BETA1 = 0.9  # AdamW's first-moment decay (`engine/optimizer.py`)


def _host_params(named) -> Dict[str, torch.Tensor]:
    return {k: p.detach().to("cpu", copy=True) for k, p in named}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gap(program: Dict[str, float], reference: Dict[str, float], keep=None):
    """(worst gap, its leaf): |program norm - reference norm| over the larger
    of the reference norm and the median reference norm, over the leaves in
    `keep` (all by default). A leaf the program lacks reads as 0."""
    names = [k for k in reference if keep is None or k in keep]
    median = statistics.median(reference[k] for k in names)
    worst, which = 0.0, None
    for k in names:
        gap = abs(program.get(k, 0.0) - reference[k]) / max(reference[k], median, 1e-30)
        if not gap <= worst:
            worst, which = gap, k
    return worst, which


def median_leaf_gap(program: Dict[str, float], reference: Dict[str, float], keep=None) -> float:
    """The median over the leaves of `leaf_gap`'s per-leaf gap."""
    names = [k for k in reference if keep is None or k in keep]
    median = statistics.median(reference[k] for k in names)
    return statistics.median(abs(program.get(k, 0.0) - reference[k])
                             / max(reference[k], median, 1e-30) for k in names)


def _apply_variant(cell, trainer) -> None:
    """The faults the tests plant under the timed path (`variant`)."""
    if cell.variant == "fault:unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif cell.variant == "fault:half_batch":
        from mp_former_tpu_torch.structures import Batch

        step = trainer.run_step

        def half(batch, stage=None):
            n = batch.images.shape[0] // 2
            return step(Batch(batch.images[:n], type(batch.targets)(
                *(t[:n] for t in batch.targets))), stage)

        trainer.run_step = half


def _terms(out) -> Dict[str, float]:
    """A step's loss terms, without the total."""
    return {k: float(v) for k, v in out.items() if k != "total_loss"}


def terms_gap_median(program: Dict[str, float], reference: Dict[str, float]) -> float:
    """The median over the reference's nonzero loss terms of |program -
    reference| / |reference|; a term the program lacks reads as 0."""
    return statistics.median(abs(program.get(k, 0.0) - v) / abs(v)
                             for k, v in reference.items() if v != 0.0)


def _checked_steps(cell, pool, device, count_flops: bool):
    """The reference's run of the checked steps: (losses, step 1's loss
    terms, first gradients, changes, FLOPs of its first step)."""
    from .. import flops
    from ..reference.engine.optimizer import build_gradient_clipper, build_optimizer
    from ..reference.engine.train_step import train_step
    from ..reference.models.criterion import build_criterion
    from ..reference.structures import Batch, Targets

    cfg = cell.reference_cfg()
    checked = int(cell.params["checked"])
    with common.float32_exact():
        model = common.reference_model(cell, device).train()
        criterion = build_criterion(cfg)
        optimizer, scheduler = build_optimizer(cfg, model)
        clip = build_gradient_clipper(cfg)
        names = [n for g in optimizer.param_groups for n in g["names"]]
        params = dict(model.named_parameters())
        start = _host_params((n, params[n]) for n in names)
        generator = torch.Generator(device=device).manual_seed(max(cell.seed, 0))
        losses, terms, grads, step_flops = [], {}, None, None
        for i in range(checked):
            images, t = pool[i]
            batch = Batch(images.to(device), Targets(*(x.to(device) for x in t)))
            if i == 0 and count_flops:
                with flops.FlopCount() as counter:
                    out = train_step(model, criterion, optimizer, scheduler, batch, generator,
                                     clip)
                step_flops = sum(counter.by_family().values())
            else:
                out = train_step(model, criterion, optimizer, scheduler, batch, generator, clip)
            losses.append(float(out["total_loss"]))
            if i == 0:
                terms = _terms(out)
                grads = {n: optimizer.state[params[n]]["exp_avg"].detach().cpu() / (1 - BETA1)
                         for n in names if params[n] in optimizer.state}
        changes = {n: params[n].detach().cpu() - start[n] for n in names}
    return losses, terms, grads, changes, step_flops


def run(cell) -> Outcome:
    p = cell.params
    device = torch.device(cell.device)
    extra = ["TPU.COMPUTE_DTYPE", "bfloat16"] if cell.variant == "control" else []
    cfg = cell.program_cfg(extra)
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.structures import Batch, Targets

    model = common.program_model(cell, cfg, device)
    trainer = Trainer(cfg, train_loader=[], model=model, device=device)
    del model
    pool = data.train_pool(cell.seed, int(p["pool"]), image_size=int(p["image_size"]),
                           num_classes=int(cell.config["cfg"]["MODEL"]["SEM_SEG_HEAD"]["NUM_CLASSES"]),
                           slots=int(p["slots"]), instances=p["instances"],
                           stride=int(p["gt_stride"]))
    pin = device.type == "cuda"
    batches = [Batch(images.pin_memory() if pin else images,
                     Targets(*(x.pin_memory() if pin else x for x in t))) for images, t in pool]
    _apply_variant(cell, trainer)

    # set-up: one step on each batch of the pool; the first `checked` are held
    checked = int(p["checked"])
    names = [n for g in trainer.optimizer.param_groups for n in g["names"]]
    params = dict(trainer.model.named_parameters())
    start = _host_params((n, params[n]) for n in names)
    losses, terms, grads, changes = [], {}, {}, {}
    for i, batch in enumerate(batches):
        out = trainer.run_step(batch)
        if i < checked:
            losses.append(float(out["total_loss"]))
        if i == 0:
            terms = _terms(out)
            state = trainer.optimizer.state
            grads = {n: state[params[n]]["exp_avg"].detach().cpu() / (1 - BETA1)
                     for n in names if params[n] in state and "exp_avg" in state[params[n]]}
        if i == checked - 1:
            changes = {n: params[n].detach().cpu() - start[n] for n in names}
    common.sync(device)
    setup_s = common.now() - cell.t0

    # the window
    instruments = common.Instruments(cell.trace, int(p["profile_skip"]), int(p["profile_device"]),
                                     int(p["profile_ranges"]), device.type)
    common.peak_reset(device)
    instruments.start()
    totals = []
    steps = 0
    t_start = common.now()
    while True:
        matcher_s = trainer.criterion.matcher_host_seconds
        out = trainer.run_step(batches[(len(batches) + steps) % len(batches)])
        instruments.add_span("matcher_host_s", trainer.criterion.matcher_host_seconds - matcher_s)
        totals.append(out["total_loss"])
        steps += 1
        instruments.step()
        if common.now() - t_start >= cell.seconds:
            break
    common.sync(device)
    t_end = common.now()
    instruments.close()
    peak = common.peak_bytes(device)
    failed = sum(1 for t in totals if not math.isfinite(float(t)))
    images = steps * len(p["instances"])

    readings = instruments.readings
    del trainer, batches, totals, out
    common.free(device)

    # the reference follows the checked steps
    ref_losses, ref_terms, ref_grads, ref_changes, step_flops = _checked_steps(
        cell, pool, device, count_flops=readings is not None)
    if readings is not None and readings.device_units and step_flops is not None:
        readings.flops = step_flops * readings.device_units
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if len(gaps) != checked:
        gaps = [float("inf")] * checked
    ref_grad_norms = _norms(ref_grads)
    grad_norms = _norms(grads)
    grad_gap, grad_leaf = leaf_gap(grad_norms, ref_grad_norms)
    median = statistics.median(ref_grad_norms.values())
    moving = {k for k, v in ref_grad_norms.items() if v >= 1e-3 * median}
    change_norms, ref_change_norms = _norms(changes), _norms(ref_changes)
    change_gap, change_leaf = leaf_gap(change_norms, ref_change_norms, moving)
    numbers = {"first_loss_gap": gaps[0],
               "first_terms_gap_median": terms_gap_median(terms, ref_terms),
               "later_loss_gap": max(gaps[1:]),
               "first_grad_gap": grad_gap,
               "first_grad_gap_median": median_leaf_gap(grad_norms, ref_grad_norms),
               "change_gap": change_gap,
               "change_gap_median": median_leaf_gap(change_norms, ref_change_norms, moving)}
    checks = [Check(k, numbers[k], limit) for k, limit in cell.workload["limits"].items()]
    print("port_bench: numbers " + json.dumps(numbers), flush=True)
    print(f"port_bench: {steps} steps of {len(p['instances'])} images in {t_end - t_start:.4f} s; "
          f"losses {losses} against the reference's {ref_losses}; worst first-gradient "
          f"leaf {grad_leaf}, worst change leaf {change_leaf} ({len(moving)} of "
          f"{len(ref_grad_norms)} leaves move)", flush=True)
    if readings is not None:
        print(f"port_bench: seconds a step by what profiled it: {readings.pace()}", flush=True)
    metrics = {"setup_s": (setup_s, "s"),
               "train_images_per_s": (images / (t_end - t_start), "images/s"),
               "peak_gib": (peak / 2 ** 30, "GiB")}
    return Outcome(steps, failed, metrics, common.device_fields(device, peak, cell.chips),
                   checks, readings, numbers)
