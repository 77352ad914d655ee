"""The port's modules against the JAX package, one at a time, at small sizes.

Each port module is built with its reference initialisation, its weights are
moved off that init with seeded noise, and its state dict goes through the
JAX package's importer of reference checkpoints; both then run the same
inputs. On the CPU the port runs its kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine import eval_loop as jax_eval_loop
from mp_former_tpu.engine.checkpoint_import import convert_pixel_decoder, convert_predictor
from mp_former_tpu.engine.convert import d2_resnet_params_from_state_dict
from mp_former_tpu.inference import instance_inference as jax_instance_inference
from mp_former_tpu.models.backbone.resnet import ResNet as JaxResNet
from mp_former_tpu.models.pixel_decoder.msdeformattn import (
    MSDeformAttnPixelDecoder as JaxPixelDecoder)
from mp_former_tpu.models.transformer_decoder.mask2former_decoder import (
    MultiScaleMaskedTransformerDecoderMaskDN as JaxDecoder)
from mp_former_tpu.models.transformer_decoder.position_encoding import (
    position_embedding_sine as jax_pe)
from mp_former_tpu.utils.interp import resize as jax_resize
from mp_former_tpu.utils.shape_spec import ShapeSpec as JaxShapeSpec

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.engine.predictor import postprocess_instance, preprocess_image
from mp_former_tpu_torch.inference import instance_inference
from mp_former_tpu_torch.models.backbone.resnet import ResNet
from mp_former_tpu_torch.models.pixel_decoder.msdeformattn import MSDeformAttnPixelDecoder
from mp_former_tpu_torch.models.transformer_decoder.mask2former_decoder import (
    MultiScaleMaskedTransformerDecoderMaskDN)
from mp_former_tpu_torch.models.transformer_decoder.position_encoding import (
    position_embedding_sine)
from mp_former_tpu_torch.utils.interp import resize
from mp_former_tpu_torch.utils.shape_spec import ShapeSpec

torch.set_num_threads(2)


def _perturb_(module, seed, scale=0.02):
    """Seeded noise on every parameter and buffer (FrozenBN variances stay
    positive); returns the state dict as numpy."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            noise = rng.normal(0.0, scale, t.shape).astype(np.float32)
            if name.endswith("running_var"):
                noise = np.abs(noise)
            t.add_(torch.from_numpy(noise))
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _nhwc(x):
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), 1, -1))


def test_resnet_matches_jax():
    kw = dict(depth=50, stride_in_1x1=False, width_per_group=8, stem_out_channels=16,
              res2_out_channels=32)
    torch.manual_seed(0)
    net = ResNet(**kw).eval()
    sd = _perturb_(net, 1)
    params = d2_resnet_params_from_state_dict(sd, prefix="")
    img = np.random.RandomState(2).randn(2, 3, 64, 96).astype(np.float32)
    want = jax.jit(JaxResNet(**kw).apply)({"params": params}, jnp.asarray(_nhwc(img)))
    with torch.no_grad():
        got = net(torch.from_numpy(img))
    assert list(got) == ["res2", "res3", "res4", "res5"]
    for name, t in got.items():
        assert t.shape[-2:] == (64 // net.output_shape()[name].stride,
                                96 // net.output_shape()[name].stride)
        w = np.asarray(want[name])
        np.testing.assert_allclose(_nhwc(t.numpy()), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def _pixel_decoder_inputs(seed):
    strides = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}
    chans = {"res2": 24, "res3": 40, "res4": 48, "res5": 64}
    rng = np.random.RandomState(seed)
    feats = {k: rng.randn(2, chans[k], 96 // s, 64 // s).astype(np.float32)
             for k, s in strides.items()}
    return strides, chans, feats


def test_pixel_decoder_matches_jax():
    strides, chans, feats = _pixel_decoder_inputs(3)
    kw = dict(transformer_nheads=4, transformer_dim_feedforward=64, transformer_enc_layers=2,
              conv_dim=32, mask_dim=16)
    torch.manual_seed(0)
    dec = MSDeformAttnPixelDecoder(
        {k: ShapeSpec(channels=chans[k], stride=s) for k, s in strides.items()}, **kw)
    sd = _perturb_(dec, 4)
    params = convert_pixel_decoder({f"sem_seg_head.pixel_decoder.{k}": v for k, v in sd.items()})
    jdec = JaxPixelDecoder(
        input_shape={k: JaxShapeSpec(channels=chans[k], stride=s) for k, s in strides.items()},
        transformer_dropout=0.0, **kw)
    want_mf, want_tx, want_ms = jax.jit(jdec.apply)(
        {"params": params}, {k: jnp.asarray(_nhwc(v)) for k, v in feats.items()})
    with torch.no_grad():
        got_mf, got_tx, got_ms = dec.forward_features({k: torch.from_numpy(v) for k, v in feats.items()})
    assert got_mf.shape == (2, 16, 24, 16)
    assert [tuple(m.shape[-2:]) for m in got_ms] == [(3, 2), (6, 4), (12, 8)]
    for g, w in [(got_mf, want_mf), (got_tx, want_tx)] + list(zip(got_ms, want_ms)):
        np.testing.assert_allclose(_nhwc(g.numpy()), np.asarray(w), rtol=0, atol=1e-4)


def test_decoder_eval_path_matches_jax():
    C, Q, K, L = 32, 6, 5, 3
    torch.manual_seed(0)
    dec = MultiScaleMaskedTransformerDecoderMaskDN(
        C, num_classes=K, hidden_dim=C, num_queries=Q, nheads=4, dim_feedforward=64,
        dec_layers=4, mask_dim=16)
    sd = _perturb_(dec, 5, scale=0.05)
    assert "label_enc.weight" in sd  # unused at inference, kept for the checkpoint
    params = convert_predictor({f"sem_seg_head.predictor.{k}": v for k, v in sd.items()})
    rng = np.random.RandomState(6)
    x = [rng.randn(2, C, h, w).astype(np.float32) for h, w in [(3, 2), (6, 4), (12, 8)]]
    mf = rng.randn(2, 16, 24, 16).astype(np.float32)
    jdec = JaxDecoder(in_channels=C, num_classes=K, hidden_dim=C, num_queries=Q, nheads=4,
                      dim_feedforward=64, dec_layers=4, mask_dim=16)
    want = jax.jit(lambda p, x, mf: jdec.apply(p, x, mf, None))(
        {"params": params}, [jnp.asarray(_nhwc(a)) for a in x], jnp.asarray(_nhwc(mf)))
    with torch.no_grad():
        got = dec([torch.from_numpy(a) for a in x], torch.from_numpy(mf))
    assert got["pred_logits"].shape == (2, Q, K + 1)
    assert got["pred_masks"].shape == (2, Q, 24, 16)
    assert len(got["aux_outputs"]) == 4
    np.testing.assert_allclose(got["pred_logits"].numpy(), np.asarray(want["pred_logits"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["pred_masks"].numpy(), np.asarray(want["pred_masks"]),
                               rtol=0, atol=1e-4)
    for g, w in zip(got["aux_outputs"], want["aux_outputs"]):
        np.testing.assert_allclose(g["pred_masks"].numpy(), np.asarray(w["pred_masks"]),
                                   rtol=0, atol=1e-4)


def test_decoder_refuses_dn_training():
    """DN training takes every mode of the JAX decoder (their parity:
    tests/test_torch_dn_modes.py) and refuses, by name, a mode the JAX
    decoder does not know, when the decoder is built."""
    from mp_former_tpu_torch.structures import DNArgs, Targets

    targets = Targets(torch.tensor([[1, 0]]), torch.ones(1, 2, 16, 16, dtype=torch.bool),
                      torch.rand(1, 2, 4), torch.tensor([[True, False]]))
    dn_args = DNArgs(targets, scalar=2, noise_scale=0.0)
    feats, mask_features = [torch.zeros(1, 8, 2, 2)] * 3, torch.zeros(1, 8, 4, 4)
    with pytest.raises(ValueError, match="'points_mae'"):
        MultiScaleMaskedTransformerDecoderMaskDN(8, num_classes=3, hidden_dim=8, num_queries=2,
                                                 nheads=2, dec_layers=1, mask_dim=8,
                                                 dn_mode="points_mae")
    for mode in ("points", "base", "shift", "points_MAE"):
        dec = MultiScaleMaskedTransformerDecoderMaskDN(8, num_classes=3, hidden_dim=8,
                                                       num_queries=2, nheads=2, dec_layers=1,
                                                       mask_dim=8, dn_mode=mode)
        out = dec(feats, mask_features, dn_args=dn_args)
        assert out["dn_out"]["pred_logits"].shape == (1, 4, 4), mode
        assert out["pred_logits"].shape == (1, 2, 4), mode


@pytest.mark.parametrize("h,w", [(13, 21), (25, 34)])
def test_position_embedding_matches_jax(h, w):
    np.testing.assert_allclose(position_embedding_sine(h, w, 64).numpy(),
                               np.asarray(jax_pe(h, w, 64)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["bilinear", "nearest", "area"])
@pytest.mark.parametrize("size", [(7, 9), (20, 30), (12, 18)])
def test_resize_matches_jax(method, size):
    x = np.random.RandomState(7).randn(2, 3, 12, 18).astype(np.float32)
    np.testing.assert_allclose(resize(torch.from_numpy(x), size, method).numpy(),
                               np.asarray(jax_resize(jnp.asarray(x), size, method)),
                               rtol=0, atol=1e-5)


def test_instance_inference_matches_jax():
    rng = np.random.RandomState(8)
    cls = rng.randn(10, 6).astype(np.float32)
    masks = rng.randn(10, 16, 20).astype(np.float32)
    got = instance_inference(torch.from_numpy(cls), torch.from_numpy(masks), 5, 7)
    want = jax_instance_inference(jnp.asarray(cls), jnp.asarray(masks), 5, 7)
    np.testing.assert_array_equal(got.pred_classes.numpy(), np.asarray(want.pred_classes))
    np.testing.assert_array_equal(got.pred_masks.numpy(), np.asarray(want.pred_masks))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)


def test_postprocess_instance_matches_jax():
    rng = np.random.RandomState(9)
    cls = rng.randn(8, 4).astype(np.float32)
    masks = rng.randn(8, 20, 28).astype(np.float32)  # 1/4 of an 80x112 canvas
    got = postprocess_instance(torch.from_numpy(cls), torch.from_numpy(masks), (75, 101),
                               50, 67, 3, 6)
    want = jax_eval_loop.postprocess_instance(cls, masks, (75, 101), 50, 67, 3, 6)
    assert got.pred_masks.shape == (6, 50, 67)
    np.testing.assert_allclose(got.scores.numpy(), want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.pred_classes.numpy(), want[1])
    np.testing.assert_array_equal(got.pred_masks.numpy(), want[2])


@pytest.mark.parametrize("fmt", ["RGB", "BGR"])
@pytest.mark.parametrize("hw", [(48, 64), (90, 60), (40, 200)])
def test_preprocess_geometry_matches_jax(fmt, hw):
    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_list(["INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "128",
                         "INPUT.FORMAT", fmt, "MODEL.PIXEL_MEAN", "[123.675, 116.28, 103.53]"])
    img = np.random.RandomState(10).randint(0, 256, hw + (3,), dtype=np.uint8)
    img[::2] = img[::2] // 8  # some structure, so the two resizers see edges
    want, want_size = jax_eval_loop.preprocess_image(cfg, img)
    got, got_size = preprocess_image(cfg, img, "cpu")
    got = got[0].numpy()
    assert got_size == want_size
    assert got.shape == want.shape and got.shape[0] % 32 == 0 and got.shape[1] % 32 == 0
    rh, rw = got_size
    # padding is the pixel mean, exactly
    np.testing.assert_array_equal(got[rh:], want[rh:])
    np.testing.assert_array_equal(got[:, rw:], want[:, rw:])
    # cv2's fixed-point bilinear and F.interpolate round differently: a grey level
    diff = np.abs(got[:rh, :rw] - want[:rh, :rw])
    assert diff.max() <= 1.0 and diff.mean() < 0.5
