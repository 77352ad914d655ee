#!/usr/bin/env python
"""Parameter count, structure and counted FLOPs of the port's models: the
twin of `tools/analyze_model.py`, with the same arguments.

    python tools/analyze_model_torch.py --config-file <yaml> \\
        [--tasks flop param structure] [--image-size 1024] [KEY VALUE ...]

The model is `mp_former_tpu_torch.models.build_model` of the recipe (a video
recipe builds the video meta architecture), with its seeded initial weights,
on the CUDA card unless `MODEL.DEVICE cpu` is given.

- `param`: parameters plus the state dict's floating-point buffers. The JAX
  tree holds FrozenBN's statistics as parameters, where the port keeps them
  as buffers, so the total is the JAX tool's and the tensor counts differ by
  layout.
- `structure`: the same sizes to depth 2, under the port's (the
  reference's) module names.
- `flop`: the eval forward of one zero image of s x s pixels (a clip of one
  frame for a video recipe), counted by `mp_former_tpu_torch/utils/flops.py`:
  2 per multiply-add, convolutions and products as aten runs them, the
  kernels K1-K3 by their formulas whichever implementation ran. The JAX
  tool prints XLA's estimate instead.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def load_cfg(config_file: str, opts: List[str]):
    """The recipe's config, with the video keys where it names a video meta
    architecture."""
    from mp_former_tpu_torch.config import build_cfg

    cfg = build_cfg(config_file, opts)
    if cfg.MODEL.META_ARCHITECTURE.startswith("Video"):
        cfg = build_cfg(config_file, opts, video=True)
    return cfg


def build(cfg):
    """The recipe's model with its seeded initial weights, on its device."""
    import torch

    from mp_former_tpu_torch.config import cfg_device
    from mp_former_tpu_torch.models import build_model

    device = cfg_device(cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg)
    return model.to(device), device


def _weights(model) -> Tuple[List[Tuple[str, object]], int]:
    """The state dict's floating-point tensors by name, and how many of them
    are parameters: the JAX tree's leaves. Left out: the buffers outside the
    state dict (the pixel mean and std, constants in the JAX model) and the
    integer tables (Swin's relative position index, which the JAX model
    computes)."""
    weights = [(n, t) for n, t in model.state_dict().items() if t.is_floating_point()]
    params = {n for n, _ in model.named_parameters()}
    return weights, sum(n in params for n, _ in weights)


def param_count(model) -> Tuple[int, int, int]:
    """(parameters plus floating-point buffers of the state dict, parameter
    tensors, buffer tensors)."""
    weights, n_params = _weights(model)
    return sum(t.numel() for _, t in weights), n_params, len(weights) - n_params


def structure(model, depth: int = 2) -> List[Tuple[str, int]]:
    """(module name, the `param_count` tensors under it), sorted by name, to
    `depth` levels (the JAX tool's walk)."""
    sizes: Dict[str, int] = {}
    for name, t in _weights(model)[0]:
        parts = name.split(".")[:-1]
        for d in range(1, min(depth, len(parts)) + 1):
            key = ".".join(parts[:d])
            sizes[key] = sizes.get(key, 0) + t.numel()
    return sorted(sizes.items())


def forward_flops(model, size: int, device) -> Dict[str, float]:
    """FLOPs by family of the eval forward of one zero s x s image (a
    one-frame clip for a video model)."""
    import torch

    from mp_former_tpu_torch.utils.flops import FlopCount

    video = type(model).__name__.startswith("Video")
    image = torch.zeros((1, 1, size, size, 3) if video else (1, size, size, 3), device=device)
    with torch.no_grad(), FlopCount() as counter:
        model.eval()(image)
    return counter.by_family()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--tasks", nargs="+", default=["flop", "param", "structure"])
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    cfg = load_cfg(args.config_file, args.opts or [])
    model, device = build(cfg)

    if "param" in args.tasks:
        total, n_params, n_buffers = param_count(model)
        print(f"#parameters: {total / 1e6:.3f} M ({n_params} parameter tensors + {n_buffers} "
              f"buffers, FrozenBN's statistics among the buffers)")

    if "structure" in args.tasks:
        for name, n in structure(model):
            print(f"  {name}: {n / 1e6:.3f} M")

    if "flop" in args.tasks:
        s = args.image_size
        families = forward_flops(model, s, device)
        print(f"Counted FLOPs per image @{s}px: {sum(families.values()) / 1e9:.2f} GFLOPs "
              f"(counted, 2 per multiply-add, kernels by formula; {device.type})")
        for family, n in families.items():
            print(f"  {family}: {n / 1e9:.3f} GFLOPs")


if __name__ == "__main__":
    main()
