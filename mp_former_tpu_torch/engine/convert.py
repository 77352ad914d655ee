"""Weights into the port: from the JAX package's params, from a reference
`.pth`, or from a backbone's ImageNet `.pkl` (`resolve_checkpoint_path`,
`read_checkpoint`, `load_state_dict_file`, `load_weights`: the JAX package's
`engine/checkpoint_import.py` loading rules, in the port's own copy).

`state_dict_from_jax_params` is the inverse of the JAX package's
`engine/checkpoint_import.py:convert_maskformer_state_dict` (:260-276) for the
port's models (a d2 ResNet or Swin backbone, the MSDeformAttn or an FPN pixel
decoder, the masked-attention decoder, the video decoder's `query_embed`
among them, or MaskFormer-v1's `StandardTransformerDecoder`, or a per-pixel
baseline head's 1x1 conv):
conv kernels HWIO -> OIHW, Dense (in, out) -> Linear (out, in), q/k/v
projections concatenated into `in_proj_*`,
LayerNorm/GroupNorm `scale` -> `weight`, a Swin's position embedding
(1, H, W, C) -> (1, C, H, W). It takes the params tree as numpy arrays (no jax
needed) and returns the port's state dict, with the reference's names. A
tree trained with `TPU.SAMPLING_ENGINE headshare` converts the same way: only
the shape of `sampling_offsets` differs, and `load_weights` says so when such
weights meet a model built for the other engine. `named_gradients_from_jax`
carries a gradient tree across the same way, for the training tests.

A whole training state crosses both ways (`torch_state_from_jax_train_state`,
`torch_state_to_jax_train_state`, numpy only): the JAX trainer's `TrainState`
(step, params, the optax chain's state), as Orbax restores it, against the
port's `Trainer.save` layout (model, optimizer, scheduler, iteration,
generator). `tools/convert_orbax_torch.py` reads and writes the Orbax side
where JAX is installed.
"""

from __future__ import annotations

import logging
import math
import os
import pickle
import re
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

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


def _fpn_pixel_decoder(sd, p: Mapping, pre: str = "sem_seg_head.pixel_decoder.") -> None:
    """BasePixelDecoder / TransformerEncoderPixelDecoder (the inverse of JAX
    `checkpoint_import.py:convert_fpn_pixel_decoder`)."""
    for name in sorted(n for n in p if re.fullmatch(r"(adapter|layer)_\d+", n)):
        _conv(sd, f"{pre}{name}", p[name]["conv"])
        if "gn" in p[name]:
            _norm(sd, f"{pre}{name}.norm", p[name]["gn"])
    _conv(sd, f"{pre}mask_features", p["mask_features"])
    if "input_proj" in p:
        _conv(sd, f"{pre}input_proj", p["input_proj"])
    i = 0
    while f"transformer_layer_{i}" in p:
        _encoder_layer(sd, f"{pre}transformer.encoder.layers.{i}", p[f"transformer_layer_{i}"])
        i += 1


def _encoder_layer(sd, t: str, layer: Mapping) -> None:
    """A DETR encoder layer (self_attn, norm1, linear1, linear2, norm2)."""
    _mha(sd, f"{t}.self_attn", layer["self_attn"])
    for n in ("norm1", "norm2"):
        _norm(sd, f"{t}.{n}", layer[n])
    for n in ("linear1", "linear2"):
        _dense(sd, f"{t}.{n}", layer[n])


def _standard_predictor(sd, p: Mapping, pre: str = "sem_seg_head.predictor.") -> None:
    """StandardTransformerDecoder (the inverse of JAX
    `checkpoint_import.py:convert_standard_predictor`)."""
    _put(sd, f"{pre}query_embed.weight", p["query_embed"])
    _norm(sd, f"{pre}transformer.decoder.norm", p["decoder_norm"])
    _dense(sd, f"{pre}class_embed", p["class_embed"])
    for i in range(3):
        _dense(sd, f"{pre}mask_embed.layers.{i}", p["mask_embed"][f"layers_{i}"])
    if "input_proj" in p:
        _conv(sd, f"{pre}input_proj", p["input_proj"])
    i = 0
    while f"decoder_layer_{i}" in p:
        layer, t = p[f"decoder_layer_{i}"], f"{pre}transformer.decoder.layers.{i}"
        for n in ("self_attn", "multihead_attn"):
            _mha(sd, f"{t}.{n}", layer[n])
        for n in ("linear1", "linear2"):
            _dense(sd, f"{t}.{n}", layer[n])
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{t}.{n}", layer[n])
        i += 1
    i = 0
    while f"encoder_layer_{i}" in p:
        _encoder_layer(sd, f"{pre}transformer.encoder.layers.{i}", p[f"encoder_layer_{i}"])
        i += 1


def _predictor(sd, p: Mapping, pre: str = "sem_seg_head.predictor.") -> None:
    _put(sd, f"{pre}query_feat.weight", p["query_feat"])
    _put(sd, f"{pre}level_embed.weight", p["level_embed"])
    if "label_enc" in p:
        _put(sd, f"{pre}label_enc.weight", p["label_enc"])
    if "query_embed" in p:  # the video decoder's (JAX `checkpoint_import.py:228-232`)
        _put(sd, f"{pre}query_embed.weight", p["query_embed"])
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
        pixel, predictor = head["pixel_decoder"], head["predictor"]
        (_pixel_decoder if "transformer" in pixel else _fpn_pixel_decoder)(sd, pixel)
        if "kernel" in predictor:  # a per-pixel baseline head's 1x1 conv
            _conv(sd, "sem_seg_head.predictor", predictor)
        elif "query_feat" in predictor:
            _predictor(sd, predictor)
        else:
            _standard_predictor(sd, predictor)
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
            "installed: python tools/convert_orbax_torch.py --config-file <the run's yaml> "
            f"--orbax {weights} --output-dir <dir> (then MODEL.WEIGHTS "
            "<dir>/checkpoints/model_<step>.pth, or OUTPUT_DIR <dir> --resume)")
    return resolve_checkpoint_path(weights)


# -- whole training states: the JAX TrainState <-> the port's Trainer.save --

def _fields(node) -> Optional[Mapping]:
    """A restored state node's fields: a dict as Orbax restores it without a
    target, or a namedtuple (optax's states) with one; None for a leaf or a
    sequence."""
    if isinstance(node, Mapping):
        return node
    if hasattr(node, "_fields"):
        return node._asdict()
    return None


def _state_nodes(tree) -> Iterator[Mapping]:
    """The nodes of an optax chain's state, outer first, without descending
    into the parameter-shaped trees they hold."""
    fields = _fields(tree)
    if fields is None:
        if isinstance(tree, (list, tuple)):
            for x in tree:
                yield from _state_nodes(x)
        return
    yield fields
    for k, v in fields.items():
        if k not in ("mu", "nu", "trace"):
            yield from _state_nodes(v)


def _optax_parts(opt_state):
    """(the Adam node {count, mu, nu} or None, SGD's trace node or None, the
    schedule's count node), found by their fields (optax's ScaleByAdamState,
    TraceState, ScaleByScheduleState)."""
    adam = trace = schedule = None
    for node in _state_nodes(opt_state):
        keys = set(node)
        if {"count", "mu", "nu"} <= keys and adam is None:
            adam = node
        elif "trace" in keys and trace is None:
            trace = node
        elif keys == {"count"} and schedule is None:
            schedule = node
    if schedule is None or (adam is None) == (trace is None):
        raise ValueError("not the optax state of the JAX trainer (AdamW or SGD, with a "
                         "schedule): found " + str([sorted(n) for n in _state_nodes(opt_state)]))
    return adam, trace, schedule


def _as_numpy(tree):
    fields = _fields(tree)
    if fields is not None:
        return {k: _as_numpy(v) for k, v in fields.items()}
    return np.asarray(tree)


def _param_names(optimizer_state: Mapping) -> Dict[int, str]:
    """The port optimizer's parameter index -> name (`param_groups` keeps
    each group's `names`)."""
    return {i: n for g in optimizer_state["param_groups"] for n, i in zip(g["names"], g["params"])}


def torch_state_from_jax_train_state(train_state, cfg) -> Dict[str, Any]:
    """The JAX trainer's `TrainState` (step, params, opt_state; numpy
    leaves, as `tools/convert_orbax_torch.py` restores it) -> what the port's
    `Trainer.save` writes, for the model and optimizer `cfg` builds:

    - the params through `state_dict_from_jax_params` (the FrozenBN
      statistics, params with zeroed updates in JAX, become buffers);
    - AdamW: `ScaleByAdamState` mu / nu / count -> each parameter's
      `exp_avg` / `exp_avg_sq` / `step` (`mp_former_tpu/engine/optimizer.py:
      133-136`); SGD: `optax.trace` -> `momentum_buffer`; leaves the port
      does not train (FrozenBN statistics, `FREEZE_AT`) keep no state;
    - the schedule's count -> the scheduler's `last_epoch`, and each group's
      LR at that count;
    - the step -> `iteration`; `generator` None: the port's draws restart
      from `SEED` (the two packages' random streams differ anyway).
    """
    from ..models import build_model
    from .optimizer import build_lr_schedule, build_optimizer

    ts = _fields(train_state)
    model = build_model(cfg)
    load_weights(model, state_dict_from_jax_params(_as_numpy(ts["params"])))
    optimizer, scheduler = build_optimizer(cfg, model)
    adam, trace, schedule = _optax_parts(ts["opt_state"])
    opt = optimizer.state_dict()
    names = _param_names(opt)
    if adam is not None:
        mu = state_dict_from_jax_params(_as_numpy(adam["mu"]))
        nu = state_dict_from_jax_params(_as_numpy(adam["nu"]))
        step = torch.tensor(float(np.asarray(adam["count"])))
        opt["state"] = {i: {"step": step.clone(), "exp_avg": mu[n].float(),
                            "exp_avg_sq": nu[n].float()} for i, n in names.items()}
    else:
        buf = state_dict_from_jax_params(_as_numpy(trace["trace"]))
        opt["state"] = {i: {"momentum_buffer": buf[n].float()} for i, n in names.items()}
    count = int(np.asarray(schedule["count"]))
    lr = build_lr_schedule(cfg)(count)
    for g in opt["param_groups"]:
        g["lr"] = g["initial_lr"] * lr
    sched = scheduler.state_dict()
    sched.update(last_epoch=count, _step_count=count + 1,
                 _last_lr=[g["lr"] for g in opt["param_groups"]])
    return {"model": model.state_dict(), "optimizer": opt, "scheduler": sched,
            "iteration": int(np.asarray(ts["step"])), "generator": None}


def _inverse_of_conversion(params_template) -> Callable[[Mapping[str, torch.Tensor]], Any]:
    """The inverse of `state_dict_from_jax_params` on trees shaped as
    `params_template`: the conversion only renames, transposes and
    concatenates, so it is learnt by converting a tree whose entries are
    their own indices. The returned function takes a port state dict (keys
    missing from it give 0) and returns the JAX tree, dtypes as the
    template's."""
    leaves, offset = [], 0

    def tag(node):
        nonlocal offset
        fields = _fields(node)
        if fields is not None:
            return {k: tag(v) for k, v in fields.items()}
        a = np.asarray(node)
        leaves.append((offset, a.shape, a.dtype))
        ids = np.arange(offset, offset + a.size, dtype=np.float64).reshape(a.shape)
        offset += a.size
        return ids

    tagged = tag(params_template)
    index = {k: v.numpy().astype(np.int64).reshape(-1)
             for k, v in state_dict_from_jax_params(tagged).items()}
    covered = np.zeros(offset, bool)
    for ids in index.values():
        covered[ids] = True
    if not covered.all():
        raise ValueError(f"{int((~covered).sum())} entries of the JAX params have no place "
                         "in the port's state dict")
    total = offset

    def invert(sd: Mapping[str, torch.Tensor]):
        flat = np.zeros(total, np.float64)
        for k, ids in index.items():
            if k in sd:
                flat[ids] = sd[k].detach().cpu().double().numpy().reshape(-1)
        it = iter(leaves)

        def untag(node):
            fields = _fields(node)
            if fields is not None:
                return {k: untag(v) for k, v in fields.items()}
            start, shape, dtype = next(it)
            return flat[start:start + int(np.prod(shape))].reshape(shape).astype(dtype)

        return untag(params_template)

    return invert


def _replace_fields(node, new: Mapping):
    if isinstance(node, Mapping):
        return {**node, **new}
    return node._replace(**new)


def _rebuild(tree, swap: Callable[[Any], Any]):
    """`tree` with each state node passed through `swap` (which returns it,
    or a new node), outer first."""
    swapped = swap(tree)
    if swapped is not tree:
        return swapped
    fields = _fields(tree)
    if fields is not None:
        return _replace_fields(tree, {k: _rebuild(v, swap) for k, v in fields.items()
                                      if k not in ("mu", "nu", "trace")})
    if isinstance(tree, (list, tuple)):
        rebuilt = [_rebuild(x, swap) for x in tree]
        return type(tree)(*rebuilt) if hasattr(tree, "_fields") else type(tree)(rebuilt)
    return tree


def torch_state_to_jax_train_state(state: Mapping[str, Any], template):
    """What the port's `Trainer.save` writes -> the JAX trainer's
    `TrainState`, shaped as `template` (a TrainState, or its dict, whose
    opt_state is `build_optimizer(cfg, params).init(params)` of the JAX
    package; numpy or JAX leaves): the inverse of
    `torch_state_from_jax_train_state`. Leaves the port keeps no optimizer
    state for (the FrozenBN statistics, `FREEZE_AT`) get zero moments, as
    their updates are zeroed in JAX; both counts and the step come from the
    port's optimizer, scheduler and iteration."""
    ts = _fields(template)
    invert = _inverse_of_conversion(ts["params"])
    params = invert(state["model"])
    opt = state["optimizer"]
    names = _param_names(opt)
    per_param = {names[i]: v for i, v in opt["state"].items()}
    step = int(state["iteration"])
    count = int(state["scheduler"]["last_epoch"])
    _optax_parts(ts["opt_state"])  # the JAX trainer's chain, or raise

    def swap(node):
        """The Adam, trace and schedule nodes with the port's state."""
        fields = _fields(node)
        if fields is None:
            return node
        if {"count", "mu", "nu"} <= set(fields):
            return _replace_fields(node, {
                "count": np.asarray(step, np.asarray(fields["count"]).dtype),
                "mu": invert({n: v["exp_avg"] for n, v in per_param.items()}),
                "nu": invert({n: v["exp_avg_sq"] for n, v in per_param.items()})})
        if "trace" in fields:
            return _replace_fields(node, {"trace": invert(
                {n: v["momentum_buffer"] for n, v in per_param.items()})})
        if set(fields) == {"count"}:
            return _replace_fields(node, {"count": np.asarray(
                count, np.asarray(fields["count"]).dtype)})
        return node

    new = {"step": np.asarray(step, np.asarray(ts["step"]).dtype), "params": params,
           "opt_state": _rebuild(ts["opt_state"], swap)}
    return _replace_fields(template, new)


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
