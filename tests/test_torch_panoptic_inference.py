"""The port's semantic and panoptic post-processing against the JAX package on
the same seeded logits (`mp_former_tpu_torch/inference.py`,
`engine/predictor.py` against `mp_former_tpu/inference.py` and
`mp_former_tpu/engine/eval_loop.py:139-181`): panoptic fusion with nothing
kept, with stuff segments merged and with queries dropped by the overlap
rule, and the semantic maps in both orders of the crop and the inference, on
a non-square padded canvas. Id maps and segment lists must be equal, class
probabilities within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp_former_tpu import inference as jax_inference
from mp_former_tpu.engine import eval_loop as jax_eval_loop

from mp_former_tpu_torch import inference
from mp_former_tpu_torch.engine import predictor

torch.set_num_threads(2)

K, Q = 5, 12
PROB_TOL = 1e-5


def _logits(seed, h, w):
    """(Q, K+1) class logits and (Q, h, w) mask logits: masks from a few
    smooth blobs, so that queries overlap and their argmax areas differ."""
    rng = np.random.RandomState(seed)
    cls = (2.0 * rng.randn(Q, K + 1)).astype(np.float32)
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    cy, cx, r = rng.rand(Q, 1, 1), rng.rand(Q, 1, 1), 0.1 + 0.3 * rng.rand(Q, 1, 1)
    masks = 6.0 * (1.0 - ((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2) + rng.randn(Q, h, w)
    return cls, masks.astype(np.float32)


def _jax_device(cls, masks, threshold):
    return [np.asarray(a) for a in jax_inference.panoptic_inference_device(
        jnp.asarray(cls), jnp.asarray(masks), K, threshold)]


@pytest.mark.parametrize("case", ["nothing_kept", "stuff_merged", "overlap_skipped"])
def test_panoptic_inference_matches_jax(case):
    cls, masks = _logits(0, 40, 52)
    is_thing = np.array([True, False, True, False, False])
    threshold, overlap = {"nothing_kept": (0.999, 0.0), "stuff_merged": (0.0, 0.0),
                          "overlap_skipped": (0.0, 0.8)}[case]
    got_map, got_segments = inference.panoptic_inference(
        torch.from_numpy(cls), torch.from_numpy(masks), K, threshold, overlap, is_thing)
    want_map, want_segments = jax_inference.panoptic_inference(
        jnp.asarray(cls), jnp.asarray(masks), K, threshold, overlap, is_thing)
    assert got_map.dtype == np.int32
    np.testing.assert_array_equal(got_map, want_map)
    assert got_segments == want_segments
    # the device part itself, and that each case took the branch it names
    keep, labels, _, _, mask_area, original_area, final_area = _jax_device(cls, masks, threshold)
    got = [t.numpy() for t in inference.panoptic_inference_device(
        torch.from_numpy(cls), torch.from_numpy(masks), K, threshold)]
    for g, w in zip(got, _jax_device(cls, masks, threshold)):
        np.testing.assert_array_equal(g, w)
    live = keep & (mask_area > 0) & (original_area > 0) & (final_area > 0)
    ratio = mask_area / np.maximum(original_area, 1)
    if case == "nothing_kept":
        assert not keep.any() and got_segments == [] and not got_map.any()
    elif case == "stuff_merged":
        stuff = live & ~np.append(is_thing, True)[labels]  # label K: no object, never live
        assert len(set(labels[stuff])) < stuff.sum()  # two queries of one stuff class
        assert len(got_segments) < live.sum()
    else:
        assert (live & (ratio < overlap)).any() and (live & (ratio >= overlap)).any()


@pytest.mark.parametrize("task", ["semantic_after", "semantic_before", "panoptic"])
def test_postprocess_matches_jax_on_a_padded_canvas(task):
    """Masks at 1/4 of a 96x128 canvas holding a 75x101 image, post-processed
    to 50x67 (downscale) and 150x202 (upscale)."""
    cls, masks = _logits(1, 24, 32)
    is_thing = np.array([True, True, False, True, False])
    tcls, tmasks = torch.from_numpy(cls), torch.from_numpy(masks)
    for out_h, out_w in ((50, 67), (150, 202)):
        if task == "panoptic":
            got_map, got_segments = predictor.postprocess_panoptic(
                tcls, tmasks, (75, 101), out_h, out_w, K, 0.0, 0.3, is_thing)
            want_map, want_segments = jax_eval_loop.postprocess_panoptic(
                cls, masks, (75, 101), out_h, out_w, K, 0.0, 0.3, is_thing)
            assert got_map.shape == (out_h, out_w) and len(got_segments) > 1
            np.testing.assert_array_equal(got_map, want_map)
            assert got_segments == want_segments
            continue
        before = task == "semantic_before"
        got = predictor.postprocess_semantic(tcls, tmasks, (75, 101), out_h, out_w, before)
        want = jax_eval_loop.postprocess_semantic(cls, masks, (75, 101), out_h, out_w, before)
        assert got.shape == (K, out_h, out_w) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_TOL)
    if task == "semantic_after":
        np.testing.assert_allclose(
            inference.semantic_inference(tcls, tmasks).numpy(),
            np.asarray(jax_inference.semantic_inference(jnp.asarray(cls), jnp.asarray(masks))),
            rtol=0, atol=PROB_TOL)
