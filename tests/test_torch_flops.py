"""`mp_former_tpu_torch/utils/flops.py`: each kernel family's count against
its formula on the CPU, and the counter's absence when it is not entered.
The count of a whole model against the JAX model's is in
`tests/test_torch_analyze_model.py`.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from mp_former_tpu_torch.utils import flops

torch.set_num_threads(2)


def _k1(g, grad):
    from mp_former_tpu_torch.ops import ms_deform_attn as dispatch

    shapes = ((6, 5), (3, 3))
    B, Q, M, D, P = 2, 7, 2, 32, 3
    value = torch.randn(B, sum(h * w for h, w in shapes), M, D, generator=g)
    loc = torch.rand(B, Q, M, len(shapes), P, 2, generator=g)
    attn = torch.rand(B, Q, M, len(shapes), P, generator=g)
    leaves = [t.requires_grad_(grad) for t in (value, loc, attn)]
    points = B * Q * M * len(shapes) * P
    want = {"K1": flops.k1_flops(points, D)}
    if grad:
        want["K1 backward"] = flops.k1_backward_flops(points, D)
    return (lambda: dispatch.ms_deform_attn(value, shapes, loc, attn)), leaves, want, (
        dispatch, "ms_deform_attn_plain")


def _k2(g, grad):
    from mp_former_tpu_torch.ops import tap_weighting

    B, Q, P, T, M, D = 2, 5, 3, 4, 2, 8
    taps = torch.randn(B, P * Q, T * M * D, generator=g)
    w = torch.randn(B, P * Q, T * M, generator=g)
    leaves = [t.requires_grad_(grad) for t in (taps, w)]
    want = {"K2": flops.k2_flops(taps.numel())}
    if grad:
        want["K2 backward"] = flops.k2_backward_flops(taps.numel())
    return (lambda: tap_weighting.weight_taps(taps, w, P, M, D)), leaves, want, (
        tap_weighting, "weight_taps_plain")


def _k3(g, grad):
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac

    B, H, Q, S, D = 2, 3, 5, 11, 8
    q, k, v = (torch.randn(B, H, n, D, generator=g) for n in (Q, S, S))
    mask = torch.rand(B, Q, S, generator=g) < 0.3
    leaves = [t.requires_grad_(grad) for t in (q, k, v)]
    want = {"K3": flops.k3_flops(B, H, Q, S, D)}
    if grad:
        want["K3 backward"] = flops.k3_backward_flops(B, H, Q, S, D)
    return (lambda: mac.masked_attention(q, k, v, mask)), leaves, want, (
        mac, "masked_attention_plain")


def _k2_headshare(g, grad):
    """The head-shared engine's CPU route, which weighs its taps inline (the
    JAX package's multiply-and-sum) where CUDA tensors go to K2."""
    from mp_former_tpu_torch.ops.ms_deform_attn import ms_deform_attn_headshare

    shapes = ((6, 5), (3, 3))
    B, Q, M, D, P = 2, 7, 2, 8, 3
    value = torch.randn(B, sum(h * w for h, w in shapes), M, D, generator=g)
    loc = torch.rand(B, Q, len(shapes), P, 2, generator=g)
    attn = torch.rand(B, Q, M, len(shapes), P, generator=g)
    leaves = [t.requires_grad_(grad) for t in (value, loc, attn)]
    taps = len(shapes) * B * Q * P * 4 * M * D
    want = {"K2": flops.k2_flops(taps)}
    if grad:
        want["K2 backward"] = flops.k2_backward_flops(taps)
    return (lambda: ms_deform_attn_headshare(value, shapes, loc, attn)), leaves, want, None


def _row_gather(g, grad):
    from mp_former_tpu_torch.ops import row_gather

    tab = torch.randn(40, 16, generator=g)
    idx = torch.randint(0, 40, (24,), generator=g)
    return (lambda: row_gather.row_gather(tab, idx)[:4] + row_gather.row_gather_sum(tab, idx, 4)
            ), [], {}, (row_gather, "row_gather_plain")


CASES = {"K1": _k1, "K2": _k2, "K2_headshare": _k2_headshare, "K3": _k3,
         "row_gather": _row_gather}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_each_kernel_family_counts_its_formula(kernel):
    """On CPU tensors each kernel's entry counts its formula, forward and,
    where the gradient flows, backward, and no aten product: the plain
    version's own products (K3's einsums) are not counted. With the plain
    version replaced by a recorder the count is the same and the entry calls
    it once a forward (and once more for the backward's recompute): the count
    comes from the entry, not from what the plain version runs. The row
    gathers count nothing."""
    for grad in (False, True) if kernel != "row_gather" else (False,):
        run, leaves, want, plain = CASES[kernel](torch.Generator().manual_seed(0), grad)
        expect = {f: want.get(f, 0.0) for f in flops.FAMILIES}
        with flops.FlopCount() as counter:
            out = run()
            if grad:
                out.sum().backward()
        assert counter.by_family() == expect, grad
        if plain is None:
            continue
        module, name = plain
        real, calls = getattr(module, name), []

        def recorder(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        for t in leaves:
            t.grad = None
        with mock.patch.object(module, name, recorder), flops.FlopCount() as counter:
            out = run()
            if grad:
                out.sum().backward()
        assert counter.by_family() == expect, grad
        assert len(calls) == (2 if grad else 1)


def test_the_counter_is_off_unless_entered():
    """A training forward and backward of the small released model give
    bit-equal losses and gradients with a counter entered and without; no
    counter is active outside one, and the count covers the step's K1
    (forward and the encoder's recompute), K3 and both backwards."""
    from test_torch_slice import CONFIG, SMALL

    from mp_former_tpu_torch.config import build_cfg
    from mp_former_tpu_torch.models import build_model
    from mp_former_tpu_torch.structures import Batch
    from test_torch_dn_decoder import IMG, make_targets

    cfg = build_cfg(CONFIG, SMALL + ["MODEL.DEVICE", "cpu", "MODEL.DN.NUM_DN", "1"])
    _, targets = make_targets(b=2, n=3, counts=(2, 1))
    rng = np.random.RandomState(0)
    batch = Batch(torch.from_numpy((rng.rand(2, *IMG, 3) * 255).astype(np.float32)), targets)

    def step(counted: bool):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model(cfg).train()
        with flops.FlopCount() if counted else contextlib.nullcontext() as counter:
            out = model(batch.images, batch.targets, generator=torch.Generator().manual_seed(0))
            loss = out["pred_masks"].square().mean() + out["pred_logits"].square().mean()
            loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        return loss.detach(), grads, counter

    loss0, grads0, _ = step(False)
    assert not flops.counting()
    loss1, grads1, counter = step(True)
    assert not flops.counting()
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    assert all(torch.equal(grads0[n], grads1[n]) for n in grads0)
    families = counter.by_family()
    k1_forward = families["K1"] / 2
    assert families["K1"] > 0 and families["K3"] > 0
    # the encoder recomputed under remat: K1 twice, its backward once
    assert families["K1 backward"] == pytest.approx(k1_forward * 16 / 10, rel=1e-12)
    assert families["K3 backward"] == pytest.approx(families["K3"] * 10 / 4, rel=1e-12)
