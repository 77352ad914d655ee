"""The port's config loads every recipe of configs/ exactly as the JAX
package's does (`_BASE_` chains, dotted overrides, the `TPU.*` keys). Also
what the port needs of its environment: no jax, and nvcc for its kernels."""

import os
import subprocess
import sys

import pytest

from mp_former_tpu import config as jax_config
from mp_former_tpu_torch import config as torch_config

ROOT = os.path.join(os.path.dirname(__file__), "..", "configs")
FILES = sorted(os.path.relpath(os.path.join(dp, f), ROOT)
               for dp, _, fs in os.walk(ROOT) for f in fs if f.endswith(".yaml"))
SLICE = "coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml"


def _load(pkg, rel, overrides=()):
    cfg = pkg.get_cfg()
    pkg.add_deeplab_config(cfg)
    pkg.add_maskformer2_config(cfg)
    pkg.add_maskformer2_video_config(cfg)
    cfg.merge_from_file(os.path.join(ROOT, rel))
    cfg.merge_from_list(list(overrides))
    d = cfg.to_dict()
    # the one default that names the device: the TPU for one, CUDA for the other
    assert d["MODEL"].pop("DEVICE") == ("cuda" if pkg is torch_config else "tpu")
    return d


@pytest.mark.parametrize("rel", FILES)
def test_every_recipe_loads_the_same(rel):
    assert _load(torch_config, rel) == _load(jax_config, rel)


def test_slice_config_and_overrides():
    overrides = ["MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME",
                 "MultiScaleMaskedTransformerDecoderMaskDN",
                 "TPU.SAMPLING_ENGINE", "pallas", "MODEL.MASK_FORMER.DEC_LAYERS", "4",
                 "INPUT.MIN_SIZE_TRAIN", "(640, 672)"]
    got = _load(torch_config, SLICE, overrides)
    assert got == _load(jax_config, SLICE, overrides)
    mf, head = got["MODEL"]["MASK_FORMER"], got["MODEL"]["SEM_SEG_HEAD"]
    assert mf["TRANSFORMER_DECODER_NAME"] == "MultiScaleMaskedTransformerDecoderMaskDN"
    assert (mf["DEC_LAYERS"], mf["NUM_OBJECT_QUERIES"], mf["NHEADS"], mf["HIDDEN_DIM"]) == (4, 100, 8, 256)
    assert head["PIXEL_DECODER_NAME"] == "MSDeformAttnPixelDecoder"
    assert (head["TRANSFORMER_ENC_LAYERS"], head["NUM_CLASSES"]) == (6, 80)
    assert got["INPUT"]["MIN_SIZE_TRAIN"] == (640, 672)
    assert got["TPU"]["SAMPLING_ENGINE"] == "pallas"


@pytest.mark.parametrize("key,value,match", [
    ("TPU.SAMPLING_ENGINE", "headshare", None),  # ported: the model builds
    ("MODEL.MASK_FORMER.PRE_NORM", "True", None),  # ported: pre-norm layers (A18)
])
def test_unported_settings_raise(key, value, match):
    from mp_former_tpu_torch.models import build_model

    cfg = torch_config.get_cfg()
    torch_config.add_deeplab_config(cfg)
    torch_config.add_maskformer2_config(cfg)
    cfg.merge_from_file(os.path.join(ROOT, SLICE))
    cfg.merge_from_list([key, value])
    if match is None:
        model = build_model(cfg)
        if key == "MODEL.MASK_FORMER.PRE_NORM":
            layers = model.sem_seg_head.predictor.transformer_ffn_layers
            assert all(layer.normalize_before for layer in layers)
            return
        offsets = model.state_dict()[
            "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.sampling_offsets.weight"]
        assert offsets.shape == (3 * 4 * 2, 256)  # one location set for all heads
        return
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg)


def _port_modules():
    """Every module of the port, and the scripts that run with it on the card."""
    root = os.path.join(os.path.dirname(__file__), "..")
    mods = []
    for dp, _, fs in os.walk(os.path.join(root, "mp_former_tpu_torch")):
        for f in fs:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dp, f), root)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods) + ["chip_smoke", "tools.probe_torch_row_gather",
                           "tools.profile_torch_slice", "tools.make_synthetic_coco_torch",
                           "tools.make_synthetic_segm_torch", "tools.probe_torch_msda_bwd_bound",
                           "tools.probe_torch_msda_bwd_windows",
                           "tools.probe_torch_masked_attn_offset",
                           "tools.make_synthetic_ytvis_torch"]


def test_port_imports_no_jax():
    """The port runs where neither jax nor cv2 is installed: importing every
    one of its modules, `chip_smoke.py` and its tools pulls in neither jax,
    flax, cv2 nor the JAX package."""
    mods = _port_modules()
    assert "mp_former_tpu_torch.ops.tap_weighting" in mods
    assert "mp_former_tpu_torch.engine.eval_loop" in mods
    assert {"mp_former_tpu_torch.native", "mp_former_tpu_torch.data.loader",
            "mp_former_tpu_torch.data.transforms", "mp_former_tpu_torch.data.datasets.builtin",
            "mp_former_tpu_torch.data.dataset_mappers.coco_instance_new_baseline",
            "mp_former_tpu_torch.evaluation.build",
            "mp_former_tpu_torch.data.dataset_mappers.mask_former_mappers",
            "mp_former_tpu_torch.evaluation.cityscapes_eval"} <= set(mods)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "    bad = sorted({k.split('.')[0] for k in sys.modules} "
            "& {'jax', 'flax', 'cv2', 'mp_former_tpu'})\n"
            "    assert not bad, (m, bad)\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from mp_former_tpu_torch.ops import cuda_build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()
