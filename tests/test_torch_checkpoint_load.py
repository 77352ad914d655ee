"""Loading weights into the port as the JAX package loads them: the released
recipe's `MODEL.WEIGHTS` (`detectron2://ImageNetPretrained/torchvision/
R-50.pkl`, absent here) keeps the fresh initialization with a warning, a
backbone-only ImageNet `.pkl` loads partially with a logged count and gives
the backbone that `mp_former_tpu.engine.checkpoint_import.
load_reference_weights(..., allow_fresh_init=True)` gives, exactly. The files
are built here, from a seeded copy of the small model's backbone; nothing is
downloaded.
"""

import argparse
import copy
import logging
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.config import (add_deeplab_config as jax_add_deeplab,
                                  add_maskformer2_config as jax_add_mf2,
                                  get_cfg as jax_get_cfg)
from mp_former_tpu.engine.checkpoint_import import load_reference_weights
from mp_former_tpu.models import build_model as jax_build_model

from mp_former_tpu_torch.config import add_deeplab_config, add_maskformer2_config, get_cfg
from mp_former_tpu_torch.engine.convert import (load_state_dict_file, load_weights,
                                                read_checkpoint, resolve_checkpoint_path,
                                                state_dict_from_jax_params)
from mp_former_tpu_torch.engine.predictor import Predictor
from mp_former_tpu_torch.engine.trainer import Trainer
from mp_former_tpu_torch.models import build_model

from test_torch_slice import IMG, SMALL, _cfg

torch.set_num_threads(2)

ZOO = "detectron2://ImageNetPretrained/torchvision/R-50.pkl"


@pytest.fixture(scope="module")
def small():
    """The released recipe's cfg at the tests' small size, its model, and a
    backbone in detectron2's names (no prefix) with seeded values."""
    cfg = _cfg(get_cfg, add_deeplab_config, add_maskformer2_config, SMALL)
    torch.manual_seed(0)
    model = build_model(cfg)
    rng = np.random.RandomState(0)
    backbone = {k[len("backbone."):]: (v.numpy() + rng.normal(0, 0.1, v.shape)).astype(np.float32)
                for k, v in model.state_dict().items() if k.startswith("backbone.")}
    for k in backbone:
        if k.endswith("running_var"):
            backbone[k] = np.abs(backbone[k]) + 0.5
    return cfg, model, backbone


def write_pkl(path, backbone):
    """A detectron2 zoo pickle: numpy arrays under 'model', the optimizer's
    `_momentum` entries beside them, and non-array entries at the top."""
    model = dict(backbone)
    model["stem.conv1.weight_momentum"] = np.zeros_like(backbone["stem.conv1.weight"])
    model["res2.0.conv1.weight_momentum"] = np.zeros_like(backbone["res2.0.conv1.weight"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"model": model, "__author__": "torchvision", "matching_heuristics": True}, f)
    return path


def trainer_for(cfg, model, tmp_path, weights):
    cfg = cfg.clone()
    cfg.defrost()
    cfg.MODEL.WEIGHTS = weights
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    return Trainer(cfg, iter(()), model=copy.deepcopy(model), device="cpu")


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """No iopath cache and no checkpoint in the working directory."""
    monkeypatch.setenv("FVCORE_CACHE", str(tmp_path / "cache"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_released_recipe_without_weights_warns_and_starts_fresh(small, offline, caplog):
    cfg, model, _ = small
    assert cfg.MODEL.WEIGHTS == ZOO  # the Base config's, unchanged by the overrides
    trainer = trainer_for(cfg, model, offline, cfg.MODEL.WEIGHTS)
    with caplog.at_level(logging.WARNING):
        assert trainer.resume_or_load() == 0
    assert "keeping the fresh initialization" in caplog.text
    for k, v in model.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k


def test_backbone_pkl_loads_partially_from_the_cache(small, offline, caplog):
    cfg, model, backbone = small
    write_pkl(offline / "cache" / "detectron2" / ZOO[len("detectron2://"):], backbone)
    trainer = trainer_for(cfg, model, offline, ZOO)
    with caplog.at_level(logging.WARNING):
        assert trainer.resume_or_load() == 0
    own = model.state_dict()
    assert f"partial checkpoint load: {len(backbone)} loaded, {len(own) - len(backbone)} missing" \
        in caplog.text
    got = trainer.model.state_dict()
    for k, v in got.items():
        if k.startswith("backbone."):
            np.testing.assert_array_equal(v.numpy(), backbone[k[len("backbone."):]], err_msg=k)
        else:
            assert torch.equal(v, own[k]), k  # the head keeps its initialization


def test_loaded_backbone_equals_the_jax_package_load(small, tmp_path):
    cfg, model, backbone = small
    path = write_pkl(str(tmp_path / "R-50.pkl"), backbone)
    jcfg = _cfg(jax_get_cfg, jax_add_deeplab, jax_add_mf2, SMALL)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, *IMG, 3)), None, train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes["params"]))
    loaded = load_reference_weights(path, template, allow_fresh_init=True)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, loaded))
    port = copy.deepcopy(model)
    counts = load_weights(port, load_state_dict_file(path), strict=False)
    assert counts["loaded"] == len(backbone) and counts["unexpected"] == 0
    n = 0
    for k, v in port.state_dict().items():
        if k.startswith("backbone."):
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
            n += 1
    assert n == len(backbone)


def test_torchvision_names_load_as_detectron2_names(small, tmp_path):
    _, model, backbone = small
    renames = {"stem.conv1.norm.": "bn1.", "stem.conv1.": "conv1.", ".shortcut.norm.":
               ".downsample.1.", ".shortcut.": ".downsample.0."}
    tv = {}
    for k, v in backbone.items():
        for old, new in renames.items():
            k = k.replace(old, new)
        for stage in (2, 3, 4, 5):
            k = k.replace(f"res{stage}.", f"layer{stage - 1}.")
        for j in (1, 2, 3):
            k = k.replace(f".conv{j}.norm.", f".bn{j}.")
        tv[k] = torch.from_numpy(v)
    assert "layer1.0.bn1.weight" in tv and "layer1.0.downsample.1.running_mean" in tv
    tv["fc.weight"] = torch.zeros(10, 4)  # torchvision's classifier: unexpected here
    torch.save(tv, tmp_path / "resnet50.pth")
    got = load_state_dict_file(str(tmp_path / "resnet50.pth"))
    assert set(got) == {f"backbone.{k}" for k in backbone} | {"backbone.fc.weight"}
    counts = load_weights(copy.deepcopy(model), got, strict=False)
    assert counts["loaded"] == len(backbone) and counts["unexpected"] == 1
    for k, v in backbone.items():
        np.testing.assert_array_equal(got[f"backbone.{k}"].numpy(), v, err_msg=k)


def test_pth_with_objects_is_read_in_full_with_a_log_line(small, tmp_path, caplog):
    _, model, _ = small
    sd = {k: v for k, v in model.state_dict().items() if k.startswith("sem_seg_head.")}
    torch.save({"model": sd, "args": argparse.Namespace(lr=0.1)}, tmp_path / "model.pth")
    with caplog.at_level(logging.WARNING):
        got = read_checkpoint(str(tmp_path / "model.pth"))
    assert "weights_only=False" in caplog.text
    assert set(got) == set(sd)


def test_file_that_matches_no_key_raises(small, tmp_path):
    _, model, _ = small
    torch.save({"model": {"backbone.nothing.weight": torch.zeros(3)}}, tmp_path / "x.pth")
    with pytest.raises(ValueError, match="no key of the checkpoint matches"):
        load_weights(copy.deepcopy(model), load_state_dict_file(str(tmp_path / "x.pth")),
                     strict=False)


def test_predictor_raises_on_a_missing_file(small, offline):
    cfg = small[0].clone()
    cfg.defrost()
    for weights in (ZOO, str(offline / "model_final.pth")):
        cfg.MODEL.WEIGHTS = weights
        with pytest.raises(FileNotFoundError, match="not found locally"):
            Predictor(cfg, device="cpu")


def test_directory_gets_the_conversion_message(small, tmp_path):
    cfg, model, _ = small
    (tmp_path / "checkpoints" / "3").mkdir(parents=True)
    weights = str(tmp_path / "checkpoints")
    with pytest.raises(ValueError, match="Orbax checkpoint of the JAX package"):
        trainer_for(cfg, model, tmp_path, weights).resume_or_load()
    cfg = cfg.clone()
    cfg.defrost()
    cfg.MODEL.WEIGHTS = weights
    with pytest.raises(ValueError, match="Convert it where JAX is installed"):
        Predictor(cfg, device="cpu")


@pytest.mark.parametrize("where", ["cache", "checkpoints", "cwd", "none"])
def test_zoo_scheme_search_order(offline, where):
    rel = "ImageNetPretrained/torchvision/R-50.pkl"
    place = {"cache": offline / "cache" / "detectron2" / rel,
             "checkpoints": offline / "checkpoints" / "R-50.pkl", "cwd": offline / "R-50.pkl"}
    if where != "none":
        place[where].parent.mkdir(parents=True, exist_ok=True)
        place[where].write_bytes(b"")
    got = resolve_checkpoint_path("detectron2://" + rel)
    if where == "none":
        assert got is None
    else:
        assert os.path.samefile(got, place[where])
    assert resolve_checkpoint_path(str(offline / "absent.pth")) is None
