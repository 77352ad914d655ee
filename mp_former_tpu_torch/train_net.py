"""The port's training and evaluation entry point (`train_net.py:1-176`, the
JAX package's CLI, which mirrors the reference's). Same flags, same `KEY VALUE`
overrides; the released recipe (`run_50ep_no_noise_all_ly.sh`) becomes

    python -m mp_former_tpu_torch.train_net \\
        --config-file configs/coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml \\
        MODEL.DN.NUM_DN 1 MODEL.DN.NOISE_SCALE 0.0 MODEL.MASK_FORMER.DN_MODE points \\
        MODEL.MASK_FORMER.ALL_LY_DN True MODEL.MASK_FORMER.LB_NOISE_RATIO 0.2 \\
        MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME MultiScaleMaskedTransformerDecoderMaskDN \\
        OUTPUT_DIR output/run

and its evaluation (`eval.sh`) the same with `--eval-only MODEL.WEIGHTS <file>`
or `--eval-only --resume`. Flags come before the overrides. It runs on
`MODEL.DEVICE` (`cuda` by default; `cpu` runs the kernels' plain versions)
and raises where a CUDA card is asked for and there is none. A config written
for the JAX package that names its accelerator (`MODEL.DEVICE tpu`, as
`tools/ab_base_synthetic.yaml` does) runs on the port's, the CUDA card. Datasets come
from `$DETECTRON2_DATASETS` (`data/datasets/builtin.py`). `--num-gpus N`
trains and evaluates data-parallel in N processes, one a card, over NCCL
(over gloo with `MODEL.DEVICE cpu`), as the reference launches
(train_net.py:399-412); `--num-machines M --machine-rank r --dist-url
tcp://<first machine>:<port>` spans M machines. A step of N ranks is the
one-process step on the whole SOLVER.IMS_PER_BATCH (`engine/train_step.py`).
"""

from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger(__name__)


def default_argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MP-Former, the PyTorch port")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--num-gpus", type=int, default=1, help="processes (cards) a machine")
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0)
    p.add_argument("--dist-url", default="auto",
                   help="tcp://host:port of the first machine; 'auto': a free local port")
    p.add_argument("--max-eval-images", type=int, default=None)
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p


def setup(args):
    """Reference setup (train_net.py:356-370): the config from the file and
    the overrides, the INSTANT_DROP hack, frozen; logging; the merged config
    dumped to OUTPUT_DIR/config.yaml (by rank 0)."""
    from .config import build_cfg
    from .parallel.dist import is_main_process

    cfg = build_cfg(args.config_file, args.opts or [])
    # INSTANT_DROP hack (reference train_net.py:388-392)
    if cfg.SOLVER.INSTANT_DROP:
        drop = cfg.SOLVER.DROP_EP
        iters_ep = cfg.SOLVER.MAX_ITER // 12
        cfg.defrost()
        cfg.SOLVER.STEPS = (int(drop * iters_ep), int((drop + 100) * iters_ep))
        cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    if is_main_process():
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    return cfg


def verify_results(cfg, results) -> bool:
    """Check the metrics against cfg.TEST.EXPECTED_RESULTS (d2's
    `verify_results`, reference train_net.py:385): each entry is `[task,
    metric, expected, tolerance]`; raises if a metric is missing or outside
    expected +/- tolerance. True, also when the list is empty."""
    expected = cfg.TEST.EXPECTED_RESULTS
    if not expected:
        return True
    failures = []
    for task, metric, want, tol in expected:
        sub = results.get(task, {})
        got = sub.get(metric)
        if got is None:  # evaluators nest one level, e.g. {'segm': {'AP': x}}
            for v in sub.values():
                if isinstance(v, dict) and metric in v:
                    got = v[metric]
                    break
        if got is None:
            failures.append(f"{task}/{metric}: missing from results")
        elif abs(got - want) > tol:
            failures.append(f"{task}/{metric}: got {got:.4f}, expected {want} +/- {tol}")
    if failures:
        raise AssertionError("result verification failed:\n  " + "\n  ".join(failures))
    logger.info("results verified: %s", expected)
    return True


def eval_weights(cfg, resume: bool) -> str:
    """The file `--eval-only` evaluates: with `--resume`, the checkpoint that
    OUTPUT_DIR/checkpoints/last_checkpoint names where there is one, else
    MODEL.WEIGHTS (DetectionCheckpointer.resume_or_load, reference
    train_net.py:378-380, as `Trainer.resume_or_load` reads them). Raises
    where there is neither, rather than scoring a random model."""
    last = os.path.join(cfg.OUTPUT_DIR, "checkpoints", "last_checkpoint")
    if resume and os.path.isfile(last):
        with open(last) as f:
            return os.path.join(os.path.dirname(last), f.read().strip())
    if not cfg.MODEL.WEIGHTS:
        raise ValueError("--eval-only needs MODEL.WEIGHTS, or --resume with a checkpoint "
                         f"under {cfg.OUTPUT_DIR}/checkpoints")
    return cfg.MODEL.WEIGHTS


def evaluate(cfg, model, max_images=None) -> dict:
    """Every DATASETS.TEST entry through `run_evaluation` (d2's
    DefaultTrainer.test), keyed by dataset name where there are several: the
    merged results of the dataset's evaluators ({"segm": ...} for COCO
    instances and Cityscapes AP; {"sem_seg": ...} for mIoU, or the Cityscapes
    IoU and iIoU; {"panoptic_seg", "segm", "sem_seg"} for a panoptic dataset
    with the three TEST switches on)."""
    from .data.datasets import builtin  # noqa: F401  (registration)
    from .engine.eval_loop import run_evaluation

    results = {}
    for name in cfg.DATASETS.TEST:
        try:
            r = run_evaluation(cfg, model, name, max_images)
        except NotImplementedError as e:
            logger.warning("%s", e)
            continue
        results.update(r if len(cfg.DATASETS.TEST) == 1 else {name: r})
    if not results:
        logger.warning("no eval task ran")
    return results


def main(args):
    """Train, or evaluate with `--eval-only` (results returned; printed by
    rank 0). Asked for more than one process outside a process group, it
    launches them (`launch_main`), each of which runs this."""
    from .config import cfg_device
    from .parallel.dist import get_world_size, is_main_process

    if args.num_gpus * args.num_machines > 1 and get_world_size() == 1:
        return launch_main(args)

    cfg = setup(args)
    device = cfg_device(cfg)

    if args.eval_only:
        from .engine.convert import load_state_dict_file, load_weights, locate_weights
        from .models import build_model

        weights = eval_weights(cfg, args.resume)
        local = locate_weights(weights)  # an Orbax directory raises, saying how to convert it
        if local is None:
            raise FileNotFoundError(f"--eval-only: weights {weights} not found locally")
        model = build_model(cfg)
        load_weights(model, load_state_dict_file(local))
        logger.info("evaluating %s", local)
        results = evaluate(cfg, model.to(device), args.max_eval_images)
        if is_main_process():
            print(results)
        verify_results(cfg, results)
        return results

    from .engine.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    start = trainer.resume_or_load(resume=args.resume)
    trainer.train(start)
    return None


def launch_main(args, entry=None, video: bool = False) -> None:
    """`entry(args)` (by default `main`) in `--num-gpus` processes on each
    of `--num-machines` machines (`parallel/dist.py:launch`; one process:
    here), over NCCL, or gloo where the config's MODEL.DEVICE is cpu. A count
    above the machine's CUDA cards raises on NCCL."""
    from .config import build_cfg
    from .parallel.dist import launch

    cpu = build_cfg(args.config_file, args.opts or [], video=video).MODEL.DEVICE == "cpu"
    launch(entry or main, args.num_gpus, num_machines=args.num_machines,
           machine_rank=args.machine_rank, dist_url=args.dist_url, args=(args,),
           backend="gloo" if cpu else "nccl")


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
