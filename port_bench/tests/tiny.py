"""A copy of the benchmark with tiny cells of its two configurations, for the
CPU tests: every width and depth cut so that a run takes seconds on the CPU
through the kernels' plain versions."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

TINY = {"MODEL.SEM_SEG_HEAD.CONVS_DIM": 32, "MODEL.SEM_SEG_HEAD.MASK_DIM": 32,
        "MODEL.SEM_SEG_HEAD.NUM_CLASSES": 5, "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS": 1,
        "MODEL.MASK_FORMER.HIDDEN_DIM": 32, "MODEL.MASK_FORMER.DIM_FEEDFORWARD": 64,
        "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES": 8, "MODEL.MASK_FORMER.DEC_LAYERS": 3,
        "MODEL.MASK_FORMER.TRAIN_NUM_POINTS": 64}
TINY_SWIN = {"MODEL.SWIN.EMBED_DIM": 16, "MODEL.SWIN.DEPTHS": [2, 2, 2, 2],
             "MODEL.SWIN.NUM_HEADS": [1, 2, 2, 4], "MODEL.SWIN.WINDOW_SIZE": 4,
             "MODEL.SEM_SEG_HEAD.CONVS_DIM": 32, "MODEL.SEM_SEG_HEAD.MASK_DIM": 32,
             "MODEL.SEM_SEG_HEAD.NUM_CLASSES": 5, "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS": 1,
             "MODEL.MASK_FORMER.HIDDEN_DIM": 32, "MODEL.MASK_FORMER.DIM_FEEDFORWARD": 64,
             "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES": 8, "MODEL.MASK_FORMER.DEC_LAYERS": 3,
             "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 96, "TEST.DETECTIONS_PER_IMAGE": 10}


def _shrink(config: dict, changes: dict) -> dict:
    c = json.loads(json.dumps(config))
    for key, value in changes.items():
        node = c["cfg"]
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
        c["overrides"] += [key, json.dumps(value).replace('"', "")]
    return c


def tiny_copy(dst: str) -> str:
    """A copy of the benchmark under `dst` with the cells `tiny_train` and
    `tiny_serve`, beside links to the port and its recipes, so that `dst`
    stands for a checkout; returns the copy's root."""
    for name in ("mp_former_tpu_torch", "configs"):
        os.symlink(os.path.join(os.path.dirname(BENCH), name), os.path.join(dst, name))
    root = os.path.join(dst, "port_bench")
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(BENCH, "configs", "coco_r50_mp.json")) as f:
        r50 = _shrink(json.load(f), TINY)
    with open(os.path.join(BENCH, "configs", "coco_swinl.json")) as f:
        swin = _shrink(json.load(f), TINY_SWIN)
    with open(os.path.join(root, "configs", "tiny_r50.json"), "w") as f:
        json.dump(r50, f)
    with open(os.path.join(root, "configs", "tiny_swin.json"), "w") as f:
        json.dump(swin, f)
    with open(os.path.join(BENCH, "workloads", "r50_mp_train_b16_1024.json")) as f:
        train = json.load(f)
    train.update(config="tiny_r50")
    train["params"].update(instances=[1, 4], image_size=64, slots=6, pool=3, profile_skip=1,
                           profile_device=2, profile_ranges=1)
    with open(os.path.join(BENCH, "workloads", "swinl_serve_coco.json")) as f:
        serve = json.load(f)
    serve.update(config="tiny_swin")
    serve["params"].update(sizes=[[64, 48], [48, 64]], variants=2, checked=3, profile_skip=2,
                           profile_device=3, profile_ranges=2)
    for name, w in (("tiny_train", train), ("tiny_serve", serve)):
        with open(os.path.join(root, "workloads", f"{name}.json"), "w") as f:
            json.dump(w, f)
    return root
