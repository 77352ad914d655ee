"""The port's small utilities (ROADMAP A25): `utils/boxes.py` against the JAX
package's `utils/boxes.py` (exact: the same float32 arithmetic on the same
inputs), exported from `utils` as the JAX package exports them; and
`utils/memory.py:retry_if_oom`, which retries once after emptying the CUDA
cache and raises the second error (the JAX package's further retry on the
CPU is left out, ROADMAP §C)."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp_former_tpu.utils import boxes as jax_boxes

import mp_former_tpu_torch.utils as port_utils
from mp_former_tpu_torch.utils import boxes
from mp_former_tpu_torch.utils.memory import retry_if_oom


def test_boxes_match_jax():
    rng = np.random.RandomState(0)
    xyxy = rng.rand(7, 4).astype(np.float32) * 50
    xyxy[:, 2:] += xyxy[:, :2]
    for name in ("box_xyxy_to_cxcywh", "box_cxcywh_to_xyxy"):
        got = getattr(boxes, name)(torch.from_numpy(xyxy)).numpy()
        want = np.asarray(getattr(jax_boxes, name)(jnp.asarray(xyxy)))
        np.testing.assert_array_equal(got, want)
        assert getattr(port_utils, name) is getattr(boxes, name)
    masks = rng.rand(6, 13, 17) < 0.02
    masks[1] = False  # an empty mask: a zero box
    masks[2, 4, 9] = True
    for m in (masks, masks.astype(np.float32)):
        got = boxes.masks_to_boxes(torch.from_numpy(m)).numpy()
        want = np.asarray(jax_boxes.masks_to_boxes(jnp.asarray(m)))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], 0)
    assert port_utils.masks_to_boxes is boxes.masks_to_boxes


def test_retry_if_oom_retries_once_then_raises(caplog, monkeypatch):
    emptied = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    calls = []

    @retry_if_oom
    def flaky(x, fail_times):
        calls.append(x)
        if len(calls) <= fail_times:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return x * 2

    with caplog.at_level(logging.WARNING):
        assert flaky(3, fail_times=1) == 6
    assert calls == [3, 3] and emptied == [1] and "retrying once" in caplog.text
    calls.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        flaky(4, fail_times=2)  # the second error is raised, no third call
    assert calls == [4, 4] and emptied == [1, 1]

    @retry_if_oom
    def broken():
        calls.append("broken")
        raise ValueError("not a memory error")

    calls.clear()
    with pytest.raises(ValueError):
        broken()
    assert calls == ["broken"] and emptied == [1, 1]
    assert flaky.__name__ == "flaky"
