#!/usr/bin/env python
"""A training run of the JAX package (an Orbax checkpoint of its `Trainer`)
into the PyTorch port's checkpoint, and back. It runs where JAX and orbax
are installed; the port's machines have neither.

    # Orbax -> the port: a step directory (checkpoints/<step>) or the
    # checkpoints root (its last step); writes DIR/checkpoints/model_<step>.pth
    # and last_checkpoint, which `--resume` with OUTPUT_DIR DIR continues
    python tools/convert_orbax_torch.py --config-file <the run's yaml> \
        --orbax output/run/checkpoints --output-dir DIR [KEY VALUE ...]

    # the port -> Orbax: writes DIR/checkpoints/<step>/ in the JAX trainer's
    # layout (its `resume_or_load` restores it with OUTPUT_DIR DIR)
    python tools/convert_orbax_torch.py --config-file <the run's yaml> \
        --pth output/run/checkpoints/model_0000100.pth --output-dir DIR [KEY VALUE ...]

The config (file, overrides, `--video` for the YouTube-VIS recipes) is the
run's: it builds the port's model and optimizer (their parameter groups and
schedule) and the JAX package's optax chain, whose state's structure the
Orbax side takes. The arithmetic is the port's numpy-only
`engine/convert.py:torch_state_from_jax_train_state` and
`torch_state_to_jax_train_state`: parameters, AdamW moments (or SGD's
momentum), the step and the schedule's count. The port's random generator
restarts from SEED: the two packages' random streams differ.
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

logger = logging.getLogger("convert_orbax_torch")


def _instant_drop(cfg) -> None:
    """Both trainers' INSTANT_DROP rule (`train_net.py:setup`), which moves
    SOLVER.STEPS and so the LR at a step."""
    if cfg.SOLVER.INSTANT_DROP:
        iters_ep = cfg.SOLVER.MAX_ITER // 12
        cfg.SOLVER.STEPS = (int(cfg.SOLVER.DROP_EP * iters_ep),
                            int((cfg.SOLVER.DROP_EP + 100) * iters_ep))


def build_cfgs(config_file: str, opts, video: bool = False):
    """(the JAX package's cfg, the port's cfg) of one run."""
    from mp_former_tpu.config import (add_deeplab_config, add_maskformer2_config,
                                      add_maskformer2_video_config, get_cfg)
    from mp_former_tpu_torch.config import build_cfg

    jcfg = get_cfg()
    add_deeplab_config(jcfg)
    add_maskformer2_config(jcfg)
    if video:
        add_maskformer2_video_config(jcfg)
    if config_file:
        jcfg.merge_from_file(config_file)
    jcfg.merge_from_list(list(opts))
    _instant_drop(jcfg)
    tcfg = build_cfg(config_file, opts, video=video)
    tcfg.defrost()
    _instant_drop(tcfg)
    tcfg.freeze()
    return jcfg, tcfg


def orbax_step_dir(path: str) -> str:
    """The Orbax item directory of `path`: a step directory, or the
    checkpoints root's largest step (as `mp_former_tpu/engine/
    checkpoint_import.py:_load_orbax_params` reads them)."""
    steps = sorted(int(d) for d in os.listdir(path) if d.isdigit())
    step_dir = os.path.join(path, str(steps[-1])) if steps else path
    item = os.path.join(step_dir, "default")
    return os.path.abspath(item if os.path.isdir(item) else step_dir)


def restore_train_state(path: str):
    """The JAX TrainState of an Orbax checkpoint, as nested dicts of numpy
    arrays (no target: the structure is the checkpoint's own)."""
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer().restore(orbax_step_dir(path))


def orbax_to_pth(orbax_path: str, tcfg, output_dir: str) -> str:
    """Orbax -> `output_dir/checkpoints/model_<step>.pth` + `last_checkpoint`."""
    import torch

    from mp_former_tpu_torch.engine.convert import torch_state_from_jax_train_state

    state = torch_state_from_jax_train_state(restore_train_state(orbax_path), tcfg)
    ckpt_dir = os.path.join(output_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"model_{state['iteration']:07d}.pth"
    torch.save(state, os.path.join(ckpt_dir, name))
    with open(os.path.join(ckpt_dir, "last_checkpoint"), "w") as f:
        f.write(name)
    return os.path.join(ckpt_dir, name)


def jax_template(jcfg, tcfg):
    """A JAX TrainState of the run's shapes: the params tree from the port's
    model through the JAX package's importer (no JAX `model.init`), and the
    optax state of `build_optimizer(jcfg, params).init`."""
    from mp_former_tpu.engine.checkpoint_import import convert_maskformer_state_dict
    from mp_former_tpu.engine.optimizer import build_optimizer
    from mp_former_tpu.engine.train_step import create_train_state
    from mp_former_tpu_torch.models import build_model

    sd = {k: v.numpy() for k, v in build_model(tcfg).state_dict().items()}
    params = convert_maskformer_state_dict(sd)
    return create_train_state(params, build_optimizer(jcfg, params))


def pth_to_orbax(pth: str, jcfg, tcfg, output_dir: str) -> str:
    """The port's checkpoint -> `output_dir/checkpoints/<step>/` (Orbax, the
    JAX trainer's CheckpointManager layout)."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    import torch

    from mp_former_tpu_torch.engine.convert import torch_state_to_jax_train_state

    state = torch.load(pth, map_location="cpu", weights_only=True)
    template = jax.tree.map(np.asarray, jax_template(jcfg, tcfg))
    train_state = torch_state_to_jax_train_state(state, template)
    ckpt_dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
    mgr = ocp.CheckpointManager(ckpt_dir, options=ocp.CheckpointManagerOptions(
        max_to_keep=3, create=True))
    step = int(state["iteration"])
    mgr.save(step, args=ocp.args.StandardSave(train_state))
    mgr.wait_until_finished()
    return os.path.join(ckpt_dir, str(step))


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", required=True)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--orbax", help="an Orbax step directory or checkpoints root")
    src.add_argument("--pth", help="a checkpoint of the port's Trainer")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--video", action="store_true", help="a YouTube-VIS recipe")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    jcfg, tcfg = build_cfgs(args.config_file, args.opts, args.video)
    if args.orbax:
        out = orbax_to_pth(args.orbax, tcfg, args.output_dir)
    else:
        out = pth_to_orbax(args.pth, jcfg, tcfg, args.output_dir)
    logger.info("wrote %s", out)
    return out


if __name__ == "__main__":
    main()
