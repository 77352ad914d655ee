"""`TPU.REMAT_ENCODER` / `TPU.REMAT_POLICY` in the port: the pixel decoder's
encoder layers recomputed in the backward (`torch.utils.checkpoint`), at a
small size (2 encoder layers, C = 32, 4 heads), float32 unless a test says.

Remat changes where activations come from, not what is computed: the forward
is bitwise equal with it on and off, and the gradients agree within 1e-6 of
each gradient's largest entry (the recompute runs the same operations on the
same inputs). Against the JAX package's pixel decoder with the same remat
setting (`nn.remat`, `dots_saveable` for "dots"), the gradient in the input
features agrees within 1e-3 of its largest entry (float32 on both sides; the
forward agrees within 1e-4, `tests/test_torch_modules.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine.checkpoint_import import convert_pixel_decoder
from mp_former_tpu.models.pixel_decoder.msdeformattn import (
    MSDeformAttnPixelDecoder as JaxPixelDecoder)
from mp_former_tpu.utils.shape_spec import ShapeSpec as JaxShapeSpec

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.models import build_model
from mp_former_tpu_torch.models.pixel_decoder import msdeformattn
from mp_former_tpu_torch.models.pixel_decoder.msdeformattn import MSDeformAttnPixelDecoder
from mp_former_tpu_torch.ops import ms_deform_attn as msda_mod
from mp_former_tpu_torch.utils.shape_spec import ShapeSpec

from test_torch_modules import _nhwc, _perturb_, _pixel_decoder_inputs
from test_torch_slice import CONFIG, SMALL

torch.set_num_threads(2)

LAYERS = 2
KW = dict(transformer_nheads=4, transformer_dim_feedforward=64, transformer_enc_layers=LAYERS,
          conv_dim=32, mask_dim=16)


def _decoder(remat, policy="full"):
    strides, chans, feats = _pixel_decoder_inputs(3)
    torch.manual_seed(0)
    dec = MSDeformAttnPixelDecoder(
        {k: ShapeSpec(channels=chans[k], stride=s) for k, s in strides.items()},
        remat=remat, remat_policy=policy, **KW)
    sd = _perturb_(dec, 4)
    return dec, sd, strides, chans, feats


def _run(dec, feats, cotangents=None, autocast=False):
    """Outputs and, with `cotangents`, the gradients of sum(outputs *
    cotangents) in the parameters and the input features."""
    x = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
    dec.zero_grad(set_to_none=True)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        mf, tx, ms = dec.forward_features(x)
    outs = [mf, tx, *ms]
    if cotangents is None:
        return outs, None
    sum(((o.float() * c).sum() for o, c in zip(outs, cotangents))).backward()
    grads = {n: p.grad.clone() for n, p in dec.named_parameters()}
    grads.update({f"input.{k}": t.grad.clone() for k, t in x.items()})
    return [o.detach() for o in outs], grads


def _cotangents(outs, seed=7):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=g) for o in outs]


def _assert_grads_close(got, want, tol):
    assert got.keys() == want.keys()
    for name, w in want.items():
        scale = max(w.abs().max().item(), 1e-12)
        assert (got[name] - w).abs().max().item() <= tol * scale, name


class _Counting:
    """Counts the plain K1 calls and the types of their values."""

    def __init__(self, monkeypatch):
        self.dtypes = []
        plain = msda_mod.ms_deform_attn_plain

        def counted(value, *args, **kwargs):
            self.dtypes.append(value.dtype)
            return plain(value, *args, **kwargs)

        monkeypatch.setattr(msda_mod, "ms_deform_attn_plain", counted)


def test_remat_keeps_the_forward_bitwise_and_the_model_reads_the_keys(monkeypatch):
    dec, sd, _, _, feats = _decoder(remat=False)
    rdec, _, _, _, _ = _decoder(remat=True)
    rdec.load_state_dict(dec.state_dict())
    # with autograd recording, where the recompute is set up
    want, _ = _run(dec, feats)
    got, _ = _run(rdec, feats)
    assert all(g.requires_grad for g in got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(SMALL)
    assert (cfg.TPU.REMAT_ENCODER, cfg.TPU.REMAT_POLICY) == (True, "full")  # the JAX defaults
    enc = build_model(cfg).sem_seg_head.pixel_decoder.transformer
    assert (enc.remat, enc.remat_policy) == (True, "full")
    cfg.merge_from_list(["TPU.REMAT_ENCODER", "False", "TPU.REMAT_POLICY", "dots"])
    enc = build_model(cfg).sem_seg_head.pixel_decoder.transformer
    assert (enc.remat, enc.remat_policy) == (False, "dots")

    # "dots" raises on a torch without selective checkpointing, and does not
    # fall back to "full"; where autograd records nothing there is no recompute
    ddec, _, _, _, _ = _decoder(remat=True, policy="dots")
    monkeypatch.delattr(msdeformattn.ckpt, "create_selective_checkpoint_contexts")
    with pytest.raises(NotImplementedError, match="REMAT_POLICY dots"):
        _run(ddec, feats)
    with torch.no_grad():
        _run(ddec, feats)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_match_no_remat_and_jax(policy):
    dec, sd, strides, chans, feats = _decoder(remat=False)
    rdec, _, _, _, _ = _decoder(remat=True, policy=policy)
    rdec.load_state_dict(dec.state_dict())
    outs, _ = _run(dec, feats)
    cot = _cotangents(outs)
    _, want = _run(dec, feats, cot)
    _, got = _run(rdec, feats, cot)
    _assert_grads_close(got, want, 1e-6)

    # the JAX package's decoder with the same remat setting: the gradient in
    # the input features
    params = convert_pixel_decoder({f"sem_seg_head.pixel_decoder.{k}": v for k, v in sd.items()})
    jdec = JaxPixelDecoder(
        input_shape={k: JaxShapeSpec(channels=chans[k], stride=s) for k, s in strides.items()},
        transformer_dropout=0.0, remat=True, remat_policy=policy, **KW)
    jcot = [jnp.asarray(_nhwc(c.numpy())) for c in cot]

    def loss(x):
        mf, tx, ms = jdec.apply({"params": params}, x)
        return sum((o.astype(jnp.float32) * c).sum() for o, c in zip([mf, tx, *ms], jcot))

    jgrads = jax.jit(jax.grad(loss))({k: jnp.asarray(_nhwc(v)) for k, v in feats.items()})
    for k, w in jgrads.items():
        g = _nhwc(got[f"input.{k}"].numpy())
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), k


def test_remat_calls_the_plain_k1_twice_per_layer_and_once_without_a_gradient(monkeypatch):
    count = _Counting(monkeypatch)
    dec, _, _, _, feats = _decoder(remat=True)
    dec.eval()  # as build_model returns it: remat follows autograd, not the mode
    outs, _ = _run(dec, feats)
    assert len(count.dtypes) == LAYERS  # the forward
    _run(dec, feats, _cotangents(outs))
    assert len(count.dtypes) == LAYERS + 2 * LAYERS  # forward, then the recompute in the backward
    with torch.no_grad():
        _run(dec, feats)
    assert len(count.dtypes) == 4 * LAYERS
    # remat off: one call a layer with the backward too
    off, _, _, _, _ = _decoder(remat=False)
    _run(off, feats, _cotangents(outs))
    assert len(count.dtypes) == 5 * LAYERS


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_bfloat16_autocast_is_replayed_in_the_recompute(monkeypatch, policy):
    """Under a bfloat16 autocast region the recompute sees the types the
    forward saw (K1 on a bfloat16 value, the float32 islands in float32), so
    the gradients equal those without remat."""
    count = _Counting(monkeypatch)
    dec, _, _, _, feats = _decoder(remat=False)
    rdec, _, _, _, _ = _decoder(remat=True, policy=policy)
    rdec.load_state_dict(dec.state_dict())
    outs, _ = _run(dec, feats, autocast=True)
    assert outs[1].dtype == torch.bfloat16 and outs[0].dtype == torch.float32
    cot = _cotangents(outs)
    _, want = _run(dec, feats, cot, autocast=True)
    del count.dtypes[:]
    got_outs, got = _run(rdec, feats, cot, autocast=True)
    assert count.dtypes == [torch.bfloat16] * (2 * LAYERS)
    for g, w in zip(got_outs, outs):
        assert g.dtype == w.dtype and torch.equal(g, w)
    _assert_grads_close(got, want, 1e-6)

