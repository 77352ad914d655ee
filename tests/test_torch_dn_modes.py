"""Every DN (mask-piloted) mode of the port's MaskDN decoder against the JAX
decoder, at the tiny sizes of tests/test_dn_modes.py: three levels of 4, 8
and 16 pixels, 32 channels, 6 queries, 4 heads, 3 layers, two groups.

The JAX side is jitted; its `jax.random.uniform` / `randint` draws are
recorded in call order and replayed through the one function the port's
decoder draws with (tests/test_torch_dn_decoder.py:record_jax_draws), so the
order of the draws is held too: a port that draws in another order, or
another number of times, fails. The static3 modes' blocked masks are held
bit for bit, the decoder's outputs to the tolerances of
tests/test_torch_dn_decoder.py (logits 1e-3, mask logits 1e-2, float32):
`points_MAE` here, the other modes in tests/test_torch_dn_mode_outputs.py and
tests/test_torch_dn_mode_outputs_more.py. The model-level steps of the modes
are in tests/test_torch_dn_mode_steps.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine.checkpoint_import import convert_predictor
from mp_former_tpu.models.transformer_decoder.mask2former_decoder import (
    MultiScaleMaskedTransformerDecoderMaskDN as JaxMaskDN)
from mp_former_tpu.structures import DNArgs as JDNArgs, Targets as JTargets

from mp_former_tpu_torch.models.transformer_decoder import mask2former_decoder as tdec
from mp_former_tpu_torch.structures import DNArgs, Targets

from test_torch_dn_decoder import record_jax_draws, replay_draws

torch.set_num_threads(2)

STATIC3 = ["shift", "scale", "shift_scale", "patch", "points_MAE"]
DEC = dict(in_channels=32, num_classes=5, hidden_dim=32, num_queries=6, nheads=4,
           dim_feedforward=64, dec_layers=3, mask_dim=32)
SIZES = (4, 8, 16)


def _inputs(seed=0):
    """Two images' multi-scale maps (NHWC for JAX, NCHW for the port), mask
    features and three padded targets each, of varied rectangles and boxes
    (tests/test_dn_modes.py:_inputs with a batch of two)."""
    rng = np.random.RandomState(seed)
    x = [rng.randn(2, s, s, 32).astype(np.float32) for s in SIZES]
    mf = rng.randn(2, 32, 32, 32).astype(np.float32)
    masks = np.zeros((2, 3, 128, 128), bool)
    masks[0, 0, 10:60, 10:60] = masks[0, 1, 70:120, 30:100] = masks[1, 0, 0:90, 40:128] = True
    valid = np.array([[True, True, False], [True, False, False]])
    labels = rng.randint(0, 5, (2, 3))
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (2, 3, 2)), rng.uniform(0.1, 0.6, (2, 3, 2))],
                           -1).astype(np.float32)
    jt = JTargets(jnp.asarray(labels, jnp.int32), jnp.asarray(masks), jnp.asarray(boxes),
                  jnp.asarray(valid))
    tt = Targets(*(torch.from_numpy(a) for a in (labels, masks, boxes, valid)))
    return x, mf, jt, tt


def _replay(monkeypatch, recorded):
    monkeypatch.undo()
    recorded = [np.asarray(d) for d in recorded]
    replay_draws(monkeypatch, tdec, recorded)
    return recorded


@pytest.mark.parametrize("mode", STATIC3)
def test_static3_masks_equal_jax_bit_for_bit(monkeypatch, mode):
    """The noised 1/8 mask, its nearest-downsampled coarser levels (or
    points_MAE's per-level draws) and the invalid slot fully blocked: the
    JAX `_static3_blocked` against the port's `static3_blocked`, with
    DN_RATIO 0.5 picking which instances `scale` grows."""
    _, _, jt, tt = _inputs()
    dec = JaxMaskDN(in_channels=32, num_classes=5, dn_mode=mode, dn_ratio=0.5)
    size_list = [(s, s) for s in SIZES]
    recorded = record_jax_draws(monkeypatch, 5)
    apply = jax.jit(lambda gt: (dec.apply(
        {}, gt, jt, 2, 0.4, size_list, 2, 3, 6,
        method=JaxMaskDN._static3_blocked, rngs={"dn": jax.random.PRNGKey(3)}), list(recorded)))
    want, draws = apply(jnp.asarray(tt.masks.numpy(), jnp.float32))
    recorded = _replay(monkeypatch, draws)
    fg = tdec.resize(tt.masks.float(), (16, 16), "nearest") > 0.5
    fg = fg[:, None].expand(2, 2, 3, 16, 16).reshape(-1, 16, 16)
    boxes = tt.boxes[:, None].expand(2, 2, 3, 4).reshape(-1, 4)
    got = tdec.static3_blocked(mode, fg, boxes, 0.4, 0.5, size_list, None)
    assert not recorded
    valid = tt.valid[:, None, :, None]
    for lvl, (g, w) in enumerate(zip(got, want)):
        g = (g.view(2, 2, 3, -1) | ~valid).view(2, 6, -1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"level {lvl}")
    # the noise changed the mask somewhere: the comparison is not of the plain ground truth
    plain = ~fg.view(2, 2, 3, 256) | ~valid
    assert (got[2].view(2, 2, 3, 256) | ~valid).ne(plain).any()


def _decoder_pair(mode, head_dn, seed=0):
    """The port's decoder (seeded init) and the JAX decoder holding its
    weights through the JAX importer."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        tdecoder = tdec.MultiScaleMaskedTransformerDecoderMaskDN(
            DEC["in_channels"], num_classes=5, hidden_dim=32, num_queries=6, nheads=4,
            dim_feedforward=64, dec_layers=3, mask_dim=32, dn_mode=mode, head_dn=head_dn,
            all_lys=True, dn_ratio=0.5, dn_label_noise_ratio=0.2).eval()
    params = convert_predictor({k: v.numpy() for k, v in tdecoder.state_dict().items()}, "")
    jdecoder = JaxMaskDN(**DEC, dn_mode=mode, head_dn=head_dn, all_lys=True, dn_ratio=0.5,
                         dn_label_noise_ratio=0.2)
    return tdecoder, jdecoder, params


def _check(got, want, what):
    assert got["pred_logits"].shape == tuple(want["pred_logits"].shape), what
    assert np.abs(got["pred_logits"].detach().numpy() - np.asarray(want["pred_logits"])).max() \
        < 1e-3, what
    assert np.abs(got["pred_masks"].detach().numpy() - np.asarray(want["pred_masks"])).max() \
        < 1e-2, what


# every mode, with HEAD_DN where the JAX test matrix has it, in three groups
# of at most six cases: this file (beside the static3 masks), and
# tests/test_torch_dn_mode_outputs.py and tests/test_torch_dn_mode_outputs_more.py
# (Tier-1 queues a file of six tests or fewer behind its longest one,
# ROADMAP.md, "Tier-1's clock")
DECODER_CASES = ([(m, h) for m in ("points", "lb", "mask", "base") for h in (False, True)]
                 + [(m, False) for m in STATIC3])
DECODER_GROUPS = {"dn_modes": [("points_MAE", False)],
                  "outputs": [(m, h) for m in ("points", "lb", "mask") for h in (False, True)],
                  "outputs_more": [("base", False), ("base", True), ("shift", False),
                                   ("scale", False), ("shift_scale", False), ("patch", False)]}
assert sorted(sum(DECODER_GROUPS.values(), [])) == sorted(DECODER_CASES)


@pytest.mark.parametrize("mode,head_dn", DECODER_GROUPS["dn_modes"])
def test_decoder_outputs_match_jax(monkeypatch, mode, head_dn):
    check_decoder_outputs(monkeypatch, mode, head_dn)


def check_decoder_outputs(monkeypatch, mode, head_dn):
    """One mode (`DECODER_CASES`), label noise 0.2, ALL_LY_DN, noise scale
    0.2 (0.3 for the static3 modes): the learnable queries' and the DN
    block's outputs of every layer."""
    x, mf, jt, tt = _inputs()
    tdecoder, jdecoder, params = _decoder_pair(mode, head_dn)
    noise = 0.3 if mode in STATIC3 else 0.2
    recorded = record_jax_draws(monkeypatch, 5)

    @jax.jit
    def apply(p, xs, m):
        out = jdecoder.apply({"params": p}, xs, m, JDNArgs(targets=jt, scalar=2, noise_scale=noise),
                             train=True, rngs={"dn": jax.random.PRNGKey(2)})
        return out, list(recorded)

    want, draws = apply(params, [jnp.asarray(a) for a in x], jnp.asarray(mf.transpose(0, 2, 3, 1)))
    recorded = _replay(monkeypatch, draws)
    with torch.no_grad():
        got = tdecoder([torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in x],
                       torch.from_numpy(mf), DNArgs(targets=tt, scalar=2, noise_scale=noise))
    assert not recorded, "the port drew fewer times than the JAX decoder"
    assert len(draws) > 0
    _check(got, want, "final")
    for i, (g, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        _check(g, w, f"aux {i}")
    gdn, wdn = got["dn_out"], want["dn_out"]
    assert gdn["dn_args"] == {k: int(v) for k, v in wdn["dn_args"].items()} \
        == {"max_num": 3, "pad_size": 6, "scalar": 2}
    _check(gdn, wdn, "dn final")
    for i, (g, w) in enumerate(zip(gdn["aux_outputs"], wdn["aux_outputs"])):
        _check(g, w, f"dn aux {i}")
