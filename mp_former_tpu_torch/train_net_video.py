"""The port's video entry point (`train_net_video.py:1-128`, the JAX package's
video CLI, which mirrors the reference's). Same flags, same `KEY VALUE`
overrides (flags first). A YouTube-VIS recipe trains with

    python -m mp_former_tpu_torch.train_net_video \\
        --config-file configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml [--resume]

(clips of DATASETS.TRAIN[0] through `video/ytvis.py:YTVISDatasetMapper`,
SOLVER.IMS_PER_BATCH clips a step, the tube criterion of
`video/criterion.py`, `Trainer` with its checkpoints, `metrics.json` and
`--resume`; MODEL.WEIGHTS that is not found locally leaves the fresh
initialization, with a warning) and is scored with

    python -m mp_former_tpu_torch.train_net_video \\
        --config-file configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml \\
        --eval-only MODEL.WEIGHTS <file>

(or `--eval-only --resume`, as `train_net.py` reads them): every clip of
DATASETS.TEST[0] whole, in one forward, then tube AP, printed. It runs on
`MODEL.DEVICE` (`cuda` by default; `cpu` runs the kernels' plain versions).
Datasets come from `$DETECTRON2_DATASETS` (`video/ytvis.py:register_all_ytvis`),
frames as `.npy` where no decoder is installed.
"""

from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger(__name__)


def default_argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MP-Former video, the PyTorch port")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--num-gpus", type=int, default=1,
                   help="1 only: the port runs in one process on one card")
    p.add_argument("--max-eval-videos", type=int, default=None)
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p


def setup(args):
    """The config from the file and the overrides, with the video keys,
    frozen; logging; OUTPUT_DIR made, the config dumped into it."""
    from .config import build_cfg

    cfg = build_cfg(args.config_file, args.opts or [], video=True)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    return cfg


def main(args):
    if args.num_gpus > 1:
        raise NotImplementedError(f"--num-gpus {args.num_gpus}: the port trains and evaluates "
                                  "on one card in one process; distributed training and "
                                  "evaluation are ROADMAP A21")
    from .data.catalog import DatasetCatalog
    from .config import cfg_device
    from .models import build_model
    from .video.ytvis import register_all_ytvis

    cfg = setup(args)
    device = cfg_device(cfg)
    register_all_ytvis()
    if not args.eval_only:
        from .engine.trainer import Trainer
        from .video.criterion import build_video_criterion
        from .video.ytvis import build_clip_loader

        loader = build_clip_loader(cfg, DatasetCatalog.get(cfg.DATASETS.TRAIN[0]),
                                   pin_memory=device.type == "cuda")
        try:
            trainer = Trainer(cfg, loader, model=build_model(cfg),
                              criterion=build_video_criterion(cfg), device=device)
            trainer.train(trainer.resume_or_load(resume=args.resume))
        finally:
            loader.close()
        return None

    from .engine.convert import load_state_dict_file, load_weights, locate_weights
    from .train_net import eval_weights
    from .video.eval_loop import inference_on_video_dataset

    weights = eval_weights(cfg, args.resume)
    local = locate_weights(weights)
    if local is None:
        raise FileNotFoundError(f"--eval-only: weights {weights} not found locally")
    model = build_model(cfg)
    load_weights(model, load_state_dict_file(local))
    logger.info("evaluating %s", local)
    records = DatasetCatalog.get(cfg.DATASETS.TEST[0])
    results = inference_on_video_dataset(cfg, model.to(device), records, args.max_eval_videos)
    print(results)
    return results


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
