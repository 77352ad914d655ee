"""The DN (mask-piloted) training path of the port's model against the JAX
package's, at a small size: the same weights through the converter, the same
image and padded targets, `DN_MODE points`.

With `NOISE_SCALE 0.0` and `LB_NOISE_RATIO 0` the path draws nothing. Where a
case has noise, the test records what `jax.random.uniform` / `randint` return
inside the JAX decoder and hands the port the same numbers in the same order
(label flips, flipped labels' values, then one mask-noise tensor per refresh),
by replacing the one function the port's decoder draws with.

Tolerances as tests/test_torch_slice.py (float32 on both sides): logits 1e-3,
mask logits 1e-2. The model-level DN outputs are held in
tests/test_torch_dn_outputs.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine.train_step import compute_dn_groups as jax_compute_dn_groups
from mp_former_tpu.structures import Targets as JTargets

from mp_former_tpu_torch.engine.train_step import compute_dn_groups
from mp_former_tpu_torch.models.transformer_decoder import mask2former_decoder as tdec
from mp_former_tpu_torch.structures import Targets

from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.models import build_model as jax_build_model
from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.engine.convert import load_weights, state_dict_from_jax_params
from mp_former_tpu_torch.models import build_model

from test_torch_slice import SMALL, _build_pair, _cfg

torch.set_num_threads(2)

IMG = (64, 64)
DN = ["MODEL.MASK_FORMER.DN_MODE", "points", "MODEL.MASK_FORMER.ALL_LY_DN", "True",
      "MODEL.MASK_FORMER.NHEADS", "4", "MODEL.MASK_FORMER.DROPOUT", "0.0",
      "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1"]


def make_targets(b=2, n=6, size=64, counts=(3, 1), classes=80, seed=0):
    """Padded targets with rectangles as masks, valid slots first."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((b, n, size, size), bool)
    valid = np.zeros((b, n), bool)
    for i, c in enumerate(counts):
        for j in range(c):
            y, x = rng.randint(0, size // 2, 2)
            h, w = rng.randint(size // 8, size // 2, 2)
            masks[i, j, y:y + h, x:x + w] = True
            valid[i, j] = True
    t = dict(labels=rng.randint(0, classes, (b, n)), masks=masks,
             boxes=rng.rand(b, n, 4).astype(np.float32), valid=valid)
    jt = JTargets(jnp.asarray(t["labels"], jnp.int32), jnp.asarray(masks),
                  jnp.asarray(t["boxes"]), jnp.asarray(valid))
    tt = Targets(*(torch.from_numpy(t[k]) for k in ("labels", "masks", "boxes", "valid")))
    return jt, tt


def record_jax_draws(monkeypatch, num_classes):
    """Record jax.random.uniform and randint results as uniform numbers (an
    integer r out of K classes as (r + 0.5) / K, which the port's `(u *
    K).long()` turns back into r). Returns the list they are appended to;
    inside a jitted call it holds tracers, which the call returns."""
    recorded = []
    real_uniform, real_randint = jax.random.uniform, jax.random.randint

    def uniform(*args, **kwargs):
        out = real_uniform(*args, **kwargs)
        recorded.append(out.astype(jnp.float32))
        return out

    def randint(*args, **kwargs):
        out = real_randint(*args, **kwargs)
        recorded.append((out.astype(jnp.float32) + 0.5) / num_classes)
        return out

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", randint)
    return recorded


def replay_draws(monkeypatch, module, recorded):
    """Make `module.uniform` hand out the recorded draws in order (reshaped:
    the port's mask noise has a head axis of 1 the JAX one lacks)."""
    def uniform(shape, generator, device):
        rec = recorded.pop(0)
        assert rec.size == int(np.prod(shape)), (rec.shape, tuple(shape))
        return torch.from_numpy(rec.reshape(tuple(shape)).copy())

    monkeypatch.setattr(module, "uniform", uniform)


def assert_outputs_match(got, want, dn_queries):
    def check(g, w, what):
        assert g["pred_logits"].shape == tuple(w["pred_logits"].shape), what
        assert np.abs(g["pred_logits"].detach().numpy() - np.asarray(w["pred_logits"])).max() \
            < 1e-3, what
        assert np.abs(g["pred_masks"].detach().numpy() - np.asarray(w["pred_masks"])).max() \
            < 1e-2, what

    check(got, want, "final")
    assert len(got["aux_outputs"]) == len(want["aux_outputs"])
    for i, (g, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        check(g, w, f"aux {i}")
    gdn, wdn = got["dn_out"], want["dn_out"]
    assert gdn["dn_args"] == wdn["dn_args"]
    assert gdn["pred_logits"].shape[1] == gdn["dn_args"]["pad_size"] == dn_queries
    check(gdn, wdn, "dn final")
    for i, (g, w) in enumerate(zip(gdn["aux_outputs"], wdn["aux_outputs"])):
        check(g, w, f"dn aux {i}")


def seeded_base():
    """Seeded, perturbed JAX params and an image: the DN settings change no
    parameter's shape, so every case shares them."""
    _, _, params, _, _, img = _build_pair(SMALL + DN, IMG)
    return params, img


@pytest.fixture(scope="module")
def base():
    return seeded_base()


def models_for(params, overrides):
    """Both packages' models for SMALL + DN + overrides, holding `params`."""
    jmodel = jax_build_model(_cfg(jax_get_cfg, jax_add_deeplab, jax_add_mf2,
                                  SMALL + DN + overrides))
    tmodel = build_model(_cfg(get_cfg, add_deeplab_config, add_maskformer2_config,
                              SMALL + DN + overrides))
    load_weights(tmodel, state_dict_from_jax_params(params))
    return jmodel, tmodel


def run_pair(monkeypatch, base, overrides, counts=(3, 1), n=6, dn_groups=None):
    params, img = base
    jmodel, tmodel = models_for(params, overrides)
    img = np.concatenate([img, img[:, ::-1]], 0)  # a batch of two
    jt, tt = make_targets(n=n, counts=counts)
    recorded = record_jax_draws(monkeypatch, 80)

    @jax.jit
    def apply(p, x):
        out = jmodel.apply({"params": p}, x, jt, train=True, dn_groups=dn_groups,
                           rngs={"dn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)})
        return out, list(recorded)

    want, draws = apply(params, jnp.asarray(img))
    # the block's sizes are host integers in the model; jit hands them back as arrays
    want["dn_out"]["dn_args"] = {k: int(v) for k, v in want["dn_out"]["dn_args"].items()}
    monkeypatch.undo()
    recorded = [np.asarray(d) for d in draws]
    replay_draws(monkeypatch, tdec, recorded)
    got = tmodel(torch.from_numpy(img), tt, dn_groups=dn_groups)
    assert not recorded, "the port drew fewer times than the JAX decoder"
    return got, want


@pytest.mark.parametrize("scalar,counts,bucket", [(100, (7, 3), 1), (150, (7, 3), 1), (5, (7, 3), 1),
                                                  (100, (0, 0), 1), (100, (7, 3), 4),
                                                  (100, (19, 3), 8)])
def test_compute_dn_groups_matches_jax(scalar, counts, bucket):
    valid = np.zeros((2, 20), bool)
    for i, c in enumerate(counts):
        valid[i, :c] = True
    want = jax_compute_dn_groups(scalar, valid, bucket=bucket)
    assert compute_dn_groups(scalar, torch.from_numpy(valid), bucket) == want


def test_dn_self_attention_mask_matches_jax():
    from mp_former_tpu.models.transformer_decoder.mask2former_decoder import \
        _dn_tgt_mask as jax_mask
    for scalar, pad, queries in [(1, 6, 8), (5, 4, 8), (33, 3, 100)]:
        np.testing.assert_array_equal(tdec._dn_tgt_mask(scalar, pad, queries).numpy(),
                                      jax_mask(scalar, pad, queries))


def test_other_dn_modes_and_dropout_raise_by_name(base):
    """Every DN mode of the JAX decoder and DROPOUT > 0 train now (their
    parity is in tests/test_torch_dn_modes.py and
    tests/test_torch_decoder_variants.py); a DN_MODE that the JAX decoder
    does not know raises by name when the decoder is built."""
    params, img = base
    with pytest.raises(ValueError, match="'shifted'"):
        models_for(params, ["MODEL.MASK_FORMER.DN_MODE", "shifted"])
    _, tmodel = models_for(params, ["MODEL.MASK_FORMER.DN_MODE", "shift",
                                    "MODEL.MASK_FORMER.DROPOUT", "0.1"])
    _, tt = make_targets(b=1, counts=(2,))
    with torch.no_grad():
        eval_out = tmodel(torch.from_numpy(img))
        assert "dn_out" not in eval_out
        out = tmodel.train()(torch.from_numpy(img), tt, generator=torch.Generator().manual_seed(0))
        assert out["dn_out"]["dn_args"]["pad_size"] == 5 * 6  # NUM_DN 5 x 6 slots
        # dropout acts in training mode only: inference is untouched by it
        again = tmodel.eval()(torch.from_numpy(img))
    torch.testing.assert_close(again["pred_logits"], eval_out["pred_logits"], rtol=0, atol=0)
