"""FLOP counts of the port: one definition of each kernel's work, and a
counter that gives the same count whichever implementation ran.

Convention: 2 operations a multiply-add. The kernels' formulas, of shapes
alone:

- K1, multi-scale deformable sampling (`csrc/msda_fwd.cu`): a sampling point
  reads 4 taps and weighs them by the attention weight, one multiply-add each
  per channel, 5 * 2 * D a point; its backward (`csrc/msda_bwd.cu`) a dot
  product with the output gradient and an add of w * g a tap, 4 * 4 * D;
- K2, tap weighting (`csrc/tap_weight_fwd.cu`): a multiply-add a lane of the
  taps, 2 * taps; its backward a product for grad_taps and a multiply-add for
  grad_w, 3 * taps;
- K3, masked cross-attention (`csrc/masked_attn_fwd.cu`): q k^T and p v, 2 * 2
  * Q * S * D a head; its backward five such products, 5 * 2 * Q * S * D;
- the row gathers P1-P3 (`csrc/row_gather.cu`): none (their plain versions
  index, which the counter does not count either).

A count of work does not depend on the data, so the counter takes every
sampling point; `chip_smoke.py`'s bounds pass the points that land on the
map (`points`), the work the kernel does on that run's inputs.

`FlopCount` counts the aten products and convolutions by the formulas of
`torch.utils.flop_counter` (`FlopCounterMode`'s registry, read by a dispatch
mode of its own: `FlopCounterMode`'s module tracker fails on a parameter
handed to a module under `torch.no_grad`). The kernels' entry points call
`add` where they launch a kernel, and run a plain version through
`plain_counted`, which hides its aten ops from the counter and adds the
formula in their place, forward and backward. Outside a `FlopCount` the
entry points consult one module list (`counting()`) and nothing else
changes: what runs, its results and the kernels' launch counts are the same
with a counter as without.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

FAMILIES = ("convolution", "matmul", "K1", "K1 backward", "K2", "K2 backward", "K3",
            "K3 backward")

# the counters entered, innermost last
_ACTIVE: List["FlopCount"] = []


def k1_flops(points: float, channels: int) -> float:
    """K1 over `points` sampling points of `channels` channels a head."""
    return 5 * 2.0 * points * channels


def k1_backward_flops(points: float, channels: int) -> float:
    return 4 * 4.0 * points * channels


def k2_flops(taps: float) -> float:
    """K2 over `taps` lanes of taps (`taps.numel()`)."""
    return 2.0 * taps


def k2_backward_flops(taps: float) -> float:
    return 3.0 * taps


def k3_flops(batch: int, heads: int, queries: int, keys: int, channels: int) -> float:
    return 2 * 2.0 * batch * heads * queries * keys * channels


def k3_backward_flops(batch: int, heads: int, queries: int, keys: int, channels: int) -> float:
    return 5 * 2.0 * batch * heads * queries * keys * channels


def k1_points(sampling_locations: torch.Tensor) -> int:
    """Every sampling point of (B, Q, M, L, P, 2) locations."""
    return sampling_locations.numel() // 2


def _aten_count_mode():
    """A dispatch mode that adds up the FLOPs of the aten ops
    `torch.utils.flop_counter` has a formula for, by op (`counts`)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class AtenCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts: Dict[str, float] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                name = str(func._overloadpacket)
                self.counts[name] = self.counts.get(name, 0) + formula(*args, **kwargs,
                                                                       out_val=out)
            return out

    return AtenCount()


class FlopCount:
    """A context that counts the FLOPs run inside it by family (`FAMILIES`):
    the aten convolutions and products by `torch.utils.flop_counter`'s
    formulas, and the kernels by theirs, whether the CUDA kernel or its plain
    version ran. Counters nest; each counts what runs inside it."""

    def __init__(self):
        self.kernels: Dict[str, float] = {f: 0.0 for f in FAMILIES[2:]}
        self._mode = _aten_count_mode()

    def __enter__(self) -> "FlopCount":
        self._mode.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        self._mode.__exit__(*exc)

    def by_family(self) -> Dict[str, float]:
        out = {f: 0.0 for f in FAMILIES}
        for op, n in self._mode.counts.items():
            out["convolution" if "convolution" in op else "matmul"] += n
        for family, n in self.kernels.items():
            out[family] += n
        return out


def counting() -> bool:
    """Whether a `FlopCount` is entered (the one check the entry points make)."""
    return bool(_ACTIVE)


def add(family: str, flops: float) -> None:
    """Count `flops` of a kernel family in every entered counter."""
    for counter in _ACTIVE:
        counter.kernels[family] += flops


@contextlib.contextmanager
def uncounted():
    """Run the ops inside without the dispatch modes (the counters' aten
    counts) that are entered."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


class _PlainCounted(torch.autograd.Function):
    """A plain version run with its aten ops hidden from the counters: the
    forward without a graph, the backward through the same ops recomputed and
    differentiated (the same ops in the same order as autograd of the
    forward would run, so the same gradients), its formula counted."""

    @staticmethod
    def forward(ctx, fn, backward, *tensors):
        ctx.fn, ctx.backward_count = fn, backward
        ctx.save_for_backward(*tensors)
        with uncounted(), torch.no_grad():
            return fn(*tensors)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        tensors = ctx.saved_tensors
        add(*ctx.backward_count)
        with uncounted(), torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.requires_grad) for t in tensors]
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(ctx.fn(*leaves), wanted, grad_out,
                                             allow_unused=True))
        return (None, None) + tuple(next(grads) if t.requires_grad else None for t in leaves)


def plain_counted(fn: Callable[..., torch.Tensor], family: str, flops: float,
                  backward_flops: float, *tensors: torch.Tensor) -> torch.Tensor:
    """`fn(*tensors)`, a kernel's plain version, under the entered counters:
    `flops` of `family` counted in place of its aten ops, and where a
    gradient flows back through it `backward_flops` of the family's
    backward. Call it only when `counting()`."""
    add(family, flops)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _PlainCounted.apply(fn, (family + " backward", backward_flops), *tensors)
    with uncounted():
        return fn(*tensors)

