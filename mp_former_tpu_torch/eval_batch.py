"""Evaluate every checkpoint in a directory: the port's twin of the root
`eval_batch.py` (reference eval_batch.py:1-12).

    python -m mp_former_tpu_torch.eval_batch <ckpt_dir> [--config-file <yaml>] [extra ...]

Each `.pth` or `.pkl` file of the directory, in sorted order, goes to
`python -m mp_former_tpu_torch.train_net --config-file <yaml> --eval-only
MODEL.WEIGHTS <path>` with the extra arguments after it, on the CUDA card
unless they hold `MODEL.DEVICE cpu`. A checkpoint whose evaluation fails is
reported by its process and the loop goes on.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Iterator, List, Sequence, Tuple

DEFAULT_CONFIG = "configs/coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml"


def commands(ckpt_dir: str, config_file: str,
             extra: Sequence[str]) -> Iterator[Tuple[str, List[str]]]:
    """(checkpoint path, the command that evaluates it) for each `.pth` and
    `.pkl` file of `ckpt_dir`, sorted by name."""
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.endswith((".pth", ".pkl")):
            continue
        path = os.path.join(ckpt_dir, name)
        yield path, [sys.executable, "-m", "mp_former_tpu_torch.train_net", "--config-file",
                     config_file, "--eval-only", "MODEL.WEIGHTS", path, *extra]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Evaluate every checkpoint in a directory.")
    p.add_argument("ckpt_dir")
    p.add_argument("--config-file", default=DEFAULT_CONFIG)
    args, extra = p.parse_known_args(argv)
    for path, command in commands(args.ckpt_dir, args.config_file, extra):
        print(f"=== evaluating {path} ===", flush=True)
        subprocess.run(command, check=False)


if __name__ == "__main__":
    main()
