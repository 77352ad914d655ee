"""The port's semantic test-time augmentation (ROADMAP A19) against the JAX
package's `SemanticSegmentorWithTTA`, at `tests/test_tta.py`'s small size.

First the port's resize (`data/transforms.py:resize_uint8`, bilinear with
half-pixel centres rounded to uint8, no cv2) against `cv2.resize`'s
INTER_LINEAR at the passes' sizes: at most 1 grey level apart. Then the
averaged class probabilities of both segmentors on one image, the weights
carried across (`test_torch_slice._build_pair`) and the JAX side's cv2
resize replaced by the port's so that both models see the same pixels:
within 2e-5 of each other (float32 on both sides; the probabilities are
sums over the queries of products of softmax and sigmoid outputs).
"""

import cv2
import numpy as np
import torch
from unittest import mock

from mp_former_tpu.test_time_augmentation import SemanticSegmentorWithTTA as JaxTTA

from mp_former_tpu_torch.data.transforms import _resize_image
from mp_former_tpu_torch.test_time_augmentation import SemanticSegmentorWithTTA, tta_size

from test_torch_slice import SMALL, _build_pair

ADE_SEM = "configs/ade20k/semantic-segmentation/maskformer2_R50_bs16_160k.yaml"
# SMALL's narrow widths on the ADE20K recipe's own decoder, 4 classes, and
# tests/test_tta.py's augmentation: short sides 48 and 64, long side <= 96, flip
TTA_SMALL = [*SMALL[2:], "MODEL.SEM_SEG_HEAD.NUM_CLASSES", "4", "TEST.AUG.MIN_SIZES", "(48, 64)",
             "TEST.AUG.MAX_SIZE", "96", "TEST.AUG.FLIP", "True"]
IMAGE_HW = (50, 70)
PROB_TOL = 2e-5


def test_resize_within_a_grey_level_of_cv2():
    rng = np.random.RandomState(0)
    for hw, size, max_size in ((IMAGE_HW, 48, 96), (IMAGE_HW, 64, 96), ((512, 683), 512, 2048),
                               ((512, 683), 896, 3584), ((512, 683), 256, 1024)):
        img = rng.randint(0, 256, (*hw, 3), dtype=np.uint8)
        nh, nw = tta_size(*hw, size, max_size)
        got = _resize_image(img, nh, nw).astype(np.int32)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR).astype(np.int32)
        assert got.shape == want.shape == (nh, nw, 3)
        assert nh % 32 == 0 and nw % 32 == 0
        assert np.abs(got - want).max() <= 1, (hw, size)


def test_tta_matches_jax():
    jcfg, jmodel, params, tcfg, tmodel, _ = _build_pair(TTA_SMALL, (64, 96), ADE_SEM)
    img = (np.random.RandomState(0).rand(*IMAGE_HW, 3) * 255).astype(np.uint8)
    tta = SemanticSegmentorWithTTA(tcfg, tmodel)  # TEST.AUG read from the config
    assert (tta.min_sizes, tta.max_size, tta.flip) == ([48, 64], 96, True)
    passes = [(size, flipped) for size, flipped, _ in tta.passes(img)]
    assert passes == [(48, False), (48, True), (64, False), (64, True)]
    got = tta(img)

    def port_resize(image, dsize, interpolation=None):
        assert interpolation == cv2.INTER_LINEAR
        return _resize_image(image, dsize[1], dsize[0])

    with mock.patch.object(cv2, "resize", port_resize):
        want = JaxTTA(jcfg, jmodel, {"params": params}, min_sizes=[48, 64], max_size=96,
                      flip=True)(img)
    assert got.shape == want.shape == (4, *IMAGE_HW)
    assert got.dtype == np.float32 and np.isfinite(got).all() and got.min() >= 0
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
    # one pass alone is not the average: the passes differ
    with torch.inference_mode():
        first = next(tta.passes(img))[2].numpy()
    assert np.abs(first - got).max() > 10 * PROB_TOL
