"""The benchmark's count of work: FLOPs and bytes, a frozen copy of the port's
rule (`mp_former_tpu_torch/utils/flops.py`) and of `chip_smoke.py`'s bound
arithmetic, kept here so that a change to the port cannot move the
yardstick.

Convention: 2 operations a multiply-add; convolutions and products by the
formulas of `torch.utils.flop_counter`; the kernels by their own formulas, of
shapes alone:

- K1, multi-scale deformable sampling: 5 * 2 * D a sampling point; its
  backward 4 * 4 * D;
- K3, masked cross-attention: 2 * 2 * Q * S * D a head; its backward
  5 * 2 * Q * S * D.

The reference (`reference/ops/`) runs K1 and K3 as plain ops through `k1` and
`k3` below, which hide those ops from the counter and add the formula in
their place, forward and backward, so a count of the reference reads the
same work whatever implements the kernels in the port.

The least time of a call (`bound`): the larger of its bytes over the HBM's
bytes per second and its operations over the peak of the arithmetic it
runs in. A byte count reads each input once and writes each output once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

# published peaks of one NVIDIA H100 SXM (data sheet, dense, at its full 700 W
# power limit): HBM bytes/s, float32 FLOP/s outside the tensor cores, TF32
# and bfloat16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def bound_s(n_bytes: float, flops: float, peak: str) -> float:
    """The least seconds the card could take for `n_bytes` moved and `flops`
    operations at the peak `peak`."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak])


FAMILIES = ("convolution", "matmul", "K1", "K1 backward", "K2", "K2 backward", "K3",
            "K3 backward")

# the counters entered, innermost last
_ACTIVE: List["FlopCount"] = []
# entered `paused` contexts
_MUTED: List[bool] = []


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
            if formula is not None and not _MUTED:
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
    if _MUTED:
        return
    for counter in _ACTIVE:
        counter.kernels[family] += flops


@contextlib.contextmanager
def uncounted():
    """Run the ops inside without the dispatch modes (the counters' aten
    counts) that are entered."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


@contextlib.contextmanager
def paused():
    """Nothing inside is counted, though the ops take the same paths as
    under the counters (a recompute in the backward has to rebuild what the
    forward saved, and is not the step's work)."""
    _MUTED.append(True)
    try:
        yield
    finally:
        _MUTED.pop()


def once(fn: Callable) -> Callable:
    """`fn` for `torch.utils.checkpoint`: its first call (the forward) is
    counted, a second (the recompute in the backward) is not."""
    calls = []

    def run(*args, **kwargs):
        if calls:
            with paused():
                return fn(*args, **kwargs)
        calls.append(1)
        return fn(*args, **kwargs)

    return run


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



def k1(fn: Callable, value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
       attention_weights: torch.Tensor) -> torch.Tensor:
    """`fn(value, spatial_shapes, locations, weights)`, K1's plain version,
    counted by K1's formula where a counter is entered."""
    if not counting():
        return fn(value, spatial_shapes, sampling_locations, attention_weights)
    points, d = k1_points(sampling_locations), value.shape[-1]
    return plain_counted(lambda v, loc, a: fn(v, spatial_shapes, loc, a), "K1",
                         k1_flops(points, d), k1_backward_flops(points, d),
                         value, sampling_locations, attention_weights)


def k3(fn: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
       mask: torch.Tensor) -> torch.Tensor:
    """`fn(q, k, v, mask)`, K3's plain version, counted by K3's formula where a
    counter is entered."""
    if not counting():
        return fn(q, k, v, mask)
    B, H, Q, D = q.shape
    S = k.shape[2]
    return plain_counted(lambda *qkv: fn(*qkv, mask), "K3", k3_flops(B, H, Q, S, D),
                         k3_backward_flops(B, H, Q, S, D), q, k, v)
