"""Weights into the port: from the JAX package's params, from a reference
`.pth`, or from a backbone's ImageNet `.pkl` (`resolve_checkpoint_path`,
`read_checkpoint`, `load_state_dict_file`, `load_weights`: the JAX package's
`engine/checkpoint_import.py` loading rules, in the port's own copy).

`state_dict_from_jax_params` is the inverse of the JAX package's
`engine/checkpoint_import.py:convert_maskformer_state_dict` (:260-276) for the
port's models (a d2 ResNet or Swin backbone, MSDeformAttn pixel decoder,
masked-attention decoder): conv kernels HWIO -> OIHW, Dense (in, out) ->
Linear (out, in), q/k/v projections concatenated into `in_proj_*`,
LayerNorm/GroupNorm `scale` -> `weight`, a Swin's position embedding
(1, H, W, C) -> (1, C, H, W). It takes the params tree as numpy arrays (no jax
needed) and returns the port's state dict, with the reference's names. A
tree trained with `TPU.SAMPLING_ENGINE headshare` converts the same way: only
the shape of `sampling_offsets` differs, and `load_weights` says so when such
weights meet a model built for the other engine. `named_gradients_from_jax`
carries a gradient tree across the same way, for the training tests.
"""

from __future__ import annotations

import logging
import math
import os
import pickle
import re
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.backbone.swin import _relative_position_index

logger = logging.getLogger(__name__)


def _put(sd, key: str, a) -> None:
    sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _conv(sd, prefix: str, p: Mapping) -> None:
    _put(sd, f"{prefix}.weight", np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        _put(sd, f"{prefix}.bias", p["bias"])


def _dense(sd, prefix: str, p: Mapping) -> None:
    _put(sd, f"{prefix}.weight", np.asarray(p["kernel"]).T)
    if "bias" in p:
        _put(sd, f"{prefix}.bias", p["bias"])


def _norm(sd, prefix: str, p: Mapping) -> None:
    _put(sd, f"{prefix}.weight", p["scale"])
    _put(sd, f"{prefix}.bias", p["bias"])


def _frozen_bn(sd, prefix: str, p: Mapping) -> None:
    for k in ("weight", "bias", "running_mean", "running_var"):
        _put(sd, f"{prefix}.{k}", p[k])


def _mha(sd, prefix: str, p: Mapping) -> None:
    names = ("q_proj", "k_proj", "v_proj")
    _put(sd, f"{prefix}.in_proj_weight",
         np.concatenate([np.asarray(p[n]["kernel"]).T for n in names], 0))
    _put(sd, f"{prefix}.in_proj_bias", np.concatenate([np.asarray(p[n]["bias"]) for n in names]))
    _dense(sd, f"{prefix}.out_proj", p["out_proj"])


def _backbone(sd, p: Mapping, pre: str = "backbone.") -> None:
    _conv(sd, f"{pre}stem.conv1", p["stem_conv1"])
    _frozen_bn(sd, f"{pre}stem.conv1.norm", p["stem_conv1_frozen_bn"])
    blocks = [(m.group(1), int(m.group(2)), name) for name in p
              for m in [re.fullmatch(r"(res\d)_(\d+)", name)] if m]
    for stage, j, name in sorted(blocks):
        for conv in ("conv1", "conv2", "conv3", "shortcut"):
            if conv in p[name]:
                _conv(sd, f"{pre}{stage}.{j}.{conv}", p[name][conv])
                _frozen_bn(sd, f"{pre}{stage}.{j}.{conv}.norm", p[name][f"{conv}_frozen_bn"])


def _swin(sd, p: Mapping, pre: str = "backbone.") -> None:
    """The inverse of the JAX package's `engine/convert.py:swin_params_from_torch`."""
    _conv(sd, f"{pre}patch_embed.proj", p["patch_embed_proj"])
    if "patch_embed_norm" in p:
        _norm(sd, f"{pre}patch_embed.norm", p["patch_embed_norm"])
    if "absolute_pos_embed" in p:  # (1, H, W, C) -> the reference's (1, C, H, W)
        _put(sd, f"{pre}absolute_pos_embed", np.transpose(p["absolute_pos_embed"], (0, 3, 1, 2)))
    i = 0
    while f"layers_{i}_blocks_0" in p:
        j = 0
        while f"layers_{i}_blocks_{j}" in p:
            blk, t = p[f"layers_{i}_blocks_{j}"], f"{pre}layers.{i}.blocks.{j}"
            _norm(sd, f"{t}.norm1", blk["norm1"])
            _dense(sd, f"{t}.attn.qkv", blk["attn"]["qkv"])
            _dense(sd, f"{t}.attn.proj", blk["attn"]["proj"])
            _put(sd, f"{t}.attn.relative_position_bias_table",
                 blk["attn"]["relative_position_bias_table"])
            _norm(sd, f"{t}.norm2", blk["norm2"])
            _dense(sd, f"{t}.mlp.fc1", blk["mlp_fc1"])
            _dense(sd, f"{t}.mlp.fc2", blk["mlp_fc2"])
            j += 1
        if f"layers_{i}_downsample" in p:
            down = p[f"layers_{i}_downsample"]
            _norm(sd, f"{pre}layers.{i}.downsample.norm", down["norm"])
            _dense(sd, f"{pre}layers.{i}.downsample.reduction", down["reduction"])
        i += 1
    for name in sorted(n for n in p if re.fullmatch(r"norm\d", n)):
        _norm(sd, f"{pre}{name}", p[name])


def _pixel_decoder(sd, p: Mapping, pre: str = "sem_seg_head.pixel_decoder.") -> None:
    i = 0
    while f"input_proj_{i}_conv" in p:
        _conv(sd, f"{pre}input_proj.{i}.0", p[f"input_proj_{i}_conv"])
        _norm(sd, f"{pre}input_proj.{i}.1", p[f"input_proj_{i}_gn"])
        i += 1
    tx = p["transformer"]
    _put(sd, f"{pre}transformer.level_embed", tx["level_embed"])
    j = 0
    while f"encoder_layers_{j}" in tx:
        layer, t = tx[f"encoder_layers_{j}"], f"{pre}transformer.encoder.layers.{j}"
        for n in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            _dense(sd, f"{t}.self_attn.{n}", layer["self_attn"][n])
        _norm(sd, f"{t}.norm1", layer["norm1"])
        _dense(sd, f"{t}.linear1", layer["linear1"])
        _dense(sd, f"{t}.linear2", layer["linear2"])
        _norm(sd, f"{t}.norm2", layer["norm2"])
        j += 1
    _conv(sd, f"{pre}mask_features", p["mask_features"])
    k = 1
    while f"adapter_{k}_conv" in p:
        for name in (f"adapter_{k}", f"layer_{k}"):
            _conv(sd, f"{pre}{name}", p[f"{name}_conv"])
            if f"{name}_gn" in p:
                _norm(sd, f"{pre}{name}.norm", p[f"{name}_gn"])
        k += 1


def _predictor(sd, p: Mapping, pre: str = "sem_seg_head.predictor.") -> None:
    _put(sd, f"{pre}query_feat.weight", p["query_feat"])
    _put(sd, f"{pre}level_embed.weight", p["level_embed"])
    if "label_enc" in p:
        _put(sd, f"{pre}label_enc.weight", p["label_enc"])
    _norm(sd, f"{pre}decoder_norm", p["decoder_norm"])
    _dense(sd, f"{pre}class_embed", p["class_embed"])
    for i in range(3):
        _dense(sd, f"{pre}mask_embed.layers.{i}", p["mask_embed"][f"layers_{i}"])
    i = 0
    while f"transformer_self_attention_layers_{i}" in p:
        sa = p[f"transformer_self_attention_layers_{i}"]
        _mha(sd, f"{pre}transformer_self_attention_layers.{i}.self_attn", sa["self_attn"])
        _norm(sd, f"{pre}transformer_self_attention_layers.{i}.norm", sa["norm"])
        ca = p[f"transformer_cross_attention_layers_{i}"]
        _mha(sd, f"{pre}transformer_cross_attention_layers.{i}.multihead_attn", ca["multihead_attn"])
        _norm(sd, f"{pre}transformer_cross_attention_layers.{i}.norm", ca["norm"])
        ff, t = p[f"transformer_ffn_layers_{i}"], f"{pre}transformer_ffn_layers.{i}"
        _dense(sd, f"{t}.linear1", ff["linear1"])
        _dense(sd, f"{t}.linear2", ff["linear2"])
        _norm(sd, f"{t}.norm", ff["norm"])
        i += 1
    for ip in range(3):
        if f"input_proj_{ip}" in p:
            _conv(sd, f"{pre}input_proj.{ip}", p[f"input_proj_{ip}"])


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MaskFormer params ({'backbone', 'sem_seg_head'}, or the variables
    dict holding them under 'params'; a backbone alone converts too), leaves
    as numpy arrays -> the port's state dict for `load_state_dict(strict=True)`.
    The backbone is a Swin where it has a `patch_embed_proj`, as the JAX
    importer tells them apart (`checkpoint_import.py:264-267`), else a ResNet."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = OrderedDict()
    backbone = params["backbone"]
    (_swin if "patch_embed_proj" in backbone else _backbone)(sd, backbone)
    if "sem_seg_head" in params:
        head = params["sem_seg_head"]
        _pixel_decoder(sd, head["pixel_decoder"])
        _predictor(sd, head["predictor"])
    return sd


def named_gradients_from_jax(grads: Mapping[str, Any],
                             model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree (the shape of the params tree) -> {parameter name:
    gradient} for `model`'s parameters. `state_dict_from_jax_params` is a
    renaming with transposes and concatenations, so it is linear and carries
    gradients, and parameter updates, exactly as it carries parameters. The
    JAX tree also holds gradients for the FrozenBN statistics, which are
    buffers here: they are dropped."""
    sd = state_dict_from_jax_params(grads)
    return {name: sd[name] for name, _ in model.named_parameters()}


def resolve_checkpoint_path(path: str) -> Optional[str]:
    """A `MODEL.WEIGHTS` string -> a local file, or None (the JAX package's
    `engine/checkpoint_import.py:resolve_checkpoint_path`). The detectron2 zoo
    scheme of the reference's Base configs (`detectron2://ImageNetPretrained/
    torchvision/R-50.pkl`) is looked up in the iopath cache (`$FVCORE_CACHE`,
    else `~/.torch/iopath_cache`, under `detectron2/`), then as
    `checkpoints/<basename>` and `<basename>`; a plain path passes through when
    it exists."""
    if not path.startswith("detectron2://"):
        return path if os.path.exists(path) else None
    rel = path[len("detectron2://"):]
    cache = os.environ.get("FVCORE_CACHE", os.path.expanduser("~/.torch/iopath_cache"))
    for cand in (os.path.join(cache, "detectron2", rel),
                 os.path.join("checkpoints", os.path.basename(rel)), os.path.basename(rel)):
        if os.path.exists(cand):
            return cand
    return None


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The raw weights of a checkpoint file, under their own names. A
    detectron2 `.pkl` is a latin-1 pickle of numpy arrays (under 'model' or at
    the top), whose `*_momentum` entries are the optimizer's and are dropped
    (`checkpoint_import.py:23-29`); a `.pth` is read with `weights_only=True`,
    and only a file that this refuses is read again in full, with a log line.
    Entries that are not arrays (a pickle's '__author__' and the like) are
    left out."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        try:
            data = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as err:
            logger.warning("%s holds objects that torch.load(weights_only=True) refuses (%s); "
                           "reading it with weights_only=False", path, str(err).splitlines()[0])
            data = torch.load(path, map_location="cpu", weights_only=False)
    sd = data.get("model", data) if isinstance(data, dict) else data
    return {k: v for k, v in sd.items()
            if isinstance(v, (torch.Tensor, np.ndarray)) and not k.endswith("_momentum")}


# torchvision's ResNet names -> detectron2's, as the JAX package's
# `engine/convert.py:resnet_params_from_torchvision` maps them
_TORCHVISION_RENAMES = ((re.compile(r"^conv1\."), "stem.conv1."),
                        (re.compile(r"^bn1\."), "stem.conv1.norm."),
                        (re.compile(r"^layer(\d)\."), lambda m: f"res{int(m.group(1)) + 1}."),
                        (re.compile(r"\.bn(\d)\."), r".conv\1.norm."),
                        (re.compile(r"\.downsample\.0\."), ".shortcut."),
                        (re.compile(r"\.downsample\.1\."), ".shortcut.norm."))


# what a Swin file holds beyond the port's state dict: the attention masks of
# the official classification files' shifted blocks, their classification head
# and final norm (the d2 backbone's norms are `norm0`..`norm3`); the JAX
# importer reads none of them (`mp_former_tpu/engine/convert.py:62-117`).
# The persistent `relative_position_index` buffers are checked, then dropped.
_SWIN_DROPPED = re.compile(r"^backbone\.(head\.|norm\.(weight|bias)$)|\.attn_mask$")


def _window_of_table(rows: int) -> int:
    """The window size of a (2 ws - 1)^2-row relative-position bias table."""
    return (math.isqrt(rows) + 1) // 2


def _check_relative_position_index(key: str, index: np.ndarray, sd: Mapping) -> None:
    """A stored index must be the one the port computes for its window size,
    and that window must be the one of the block's bias table."""
    ws = math.isqrt(index.shape[0])
    table = sd.get(key.replace("relative_position_index", "relative_position_bias_table"))
    if (index.shape != (ws * ws, ws * ws)
            or not np.array_equal(index, _relative_position_index(ws, ws))
            or (table is not None and _window_of_table(table.shape[0]) != ws)):
        raise ValueError(
            f"{key}: the stored relative-position index of shape {tuple(index.shape)} is not "
            f"the one of a {ws}x{ws} window that the port computes (or the block's bias table "
            "has another window): the file's Swin layout does not match the model's")


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file -> the port's state dict: a reference checkpoint
    (`model_final.pth`, detectron2 format: the weights under 'model') with the
    reference's own renames (`static_query` -> `query_feat`, mask2former
    decoder :214-235; head `layer_4` -> `adapter_1`, mask_former_head.py:23-45)
    and without the training-only `criterion.*` buffers; or a backbone alone
    (an ImageNet `.pkl` of the detectron2 zoo, or torchvision's names, or an
    official Swin classification file or its d2 `.pkl`), which gets the
    `backbone.` prefix (`checkpoint_import.py:390-392`). Swin files lose the
    buffers and parts the port does not hold (`_SWIN_DROPPED`), and each
    `relative_position_index` is held against the computed one."""
    sd = read_checkpoint(path)
    if not any(k.startswith(("backbone.", "sem_seg_head.")) for k in sd):
        if "conv1.weight" in sd:
            renamed = {}
            for k, v in sd.items():
                for pattern, repl in _TORCHVISION_RENAMES:
                    k = pattern.sub(repl, k)
                renamed[k] = v
            sd = renamed
        sd = {f"backbone.{k}": v for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = OrderedDict()
    for k, v in sd.items():
        if k.startswith("criterion.") or _SWIN_DROPPED.search(k):
            continue
        if k.endswith(".relative_position_index"):
            _check_relative_position_index(k, np.asarray(v), sd)
            continue
        k = k.replace("static_query", "query_feat").replace("sem_seg_head.layer_4",
                                                             "sem_seg_head.adapter_1")
        out[k] = torch.as_tensor(v)
    return out


def locate_weights(weights: str) -> Optional[str]:
    """`MODEL.WEIGHTS` -> a local file, or None where nothing is found. A
    directory raises: it is one of the JAX package's Orbax checkpoints, which
    the port cannot read (its machines have no orbax)."""
    if os.path.isdir(weights):
        raise ValueError(
            f"MODEL.WEIGHTS {weights} is a directory, i.e. an Orbax checkpoint of the JAX "
            "package; the port reads .pth and .pkl files only. Convert it where JAX is "
            "installed: restore its params with mp_former_tpu.engine.checkpoint_import."
            "_load_orbax_params, then torch.save({'model': mp_former_tpu_torch.engine.convert."
            "state_dict_from_jax_params(params)}, 'model.pth') and point MODEL.WEIGHTS at it")
    return resolve_checkpoint_path(weights)


def load_weights(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor],
                 strict: bool = True) -> Dict[str, int]:
    """Load `state_dict` into `model`. Weights of the head-shared sampling
    engine and of the per-head engines do not interconvert: name the setting
    instead of leaving it at torch's size-mismatch list. strict: every key of
    both sides, with equal shapes. Otherwise as detectron2's checkpointer loads
    for training (`checkpoint_import.py:343-432`): the keys present in both
    with equal shapes are loaded, the missing, unexpected and shape-mismatched
    ones are counted and logged, and a file that matches no key raises. Returns
    the four counts."""
    own = model.state_dict()
    for key, tensor in state_dict.items():
        if key.endswith("relative_position_bias_table") and key in own \
                and own[key].shape != tensor.shape:
            raise ValueError(
                f"{key}: the weights are of a Swin with {_window_of_table(tensor.shape[0])}x"
                f"{_window_of_table(tensor.shape[0])} windows, the model has "
                f"{_window_of_table(own[key].shape[0])}x{_window_of_table(own[key].shape[0])} "
                "(MODEL.SWIN.WINDOW_SIZE): set it to the weights' window")
        if key.endswith("self_attn.sampling_offsets.weight") and key in own \
                and own[key].shape != tensor.shape:
            kind = {True: "head-shared (TPU.SAMPLING_ENGINE headshare)",
                    False: "per-head (TPU.SAMPLING_ENGINE packed2x2 or pallas)"}
            model_shared = own[key].shape[0] < tensor.shape[0]
            raise ValueError(
                f"{key}: the weights have {tensor.shape[0]} sampling offsets, the model "
                f"{own[key].shape[0]}: the weights were trained with {kind[not model_shared]} "
                f"sampling locations and the model was built with {kind[model_shared]}; "
                "the two do not interconvert, set TPU.SAMPLING_ENGINE to match the weights")
    matched = {k: v for k, v in state_dict.items() if k in own and own[k].shape == v.shape}
    counts = {"loaded": len(matched), "missing": len(own.keys() - state_dict.keys()),
              "unexpected": len(state_dict.keys() - own.keys()),
              "mismatched": len(state_dict.keys() & own.keys()) - len(matched)}
    if strict:
        model.load_state_dict(state_dict, strict=True)
        return counts
    if not matched:
        raise ValueError(f"no key of the checkpoint matches the model: unexpected "
                         f"{sorted(state_dict)[:10]}")
    model.load_state_dict(matched, strict=False)
    if counts["loaded"] < len(own) or counts["unexpected"] or counts["mismatched"]:
        logger.warning("partial checkpoint load: %d loaded, %d missing (e.g. %s), %d unexpected, "
                       "%d shape-mismatched", counts["loaded"], counts["missing"],
                       sorted(own.keys() - state_dict.keys())[:3], counts["unexpected"],
                       counts["mismatched"])
    return counts
