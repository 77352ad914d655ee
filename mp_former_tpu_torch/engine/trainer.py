"""The trainer (`mp_former_tpu/engine/trainer.py:60-287`): builds model,
criterion, optimizer and schedule from a cfg, loops `train_step` over the
batches of `data/loader.py::build_train_loader` (or of an iterator the caller
passes, e.g. `data/synthetic.py`), writes `metrics.json` lines with the
reference's loss keys and `data_time`, calls hooks, evaluates every
TEST.EVAL_PERIOD steps (`test`), saves and resumes with `torch.save`, keeping
the last 3 checkpoints. It runs on `cuda` unless the caller passes
`device="cpu"`, and raises when asked for `cuda` and there is none.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional, Union

import torch

from ..data.loader import build_train_loader
from ..models import build_model
from ..models.criterion import build_criterion
from ..structures import Batch
from .convert import load_state_dict_file, load_weights, locate_weights
from .optimizer import build_gradient_clipper, build_optimizer
from .train_step import train_step

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(self, cfg, train_loader: Optional[Iterable[Batch]] = None,
                 model: Optional[torch.nn.Module] = None,
                 device: Union[str, torch.device] = "cuda"):
        """`train_loader`: an iterable of `Batch`; None builds the cfg's
        loader at each `train()` call and closes it when the call ends."""
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda'): torch finds no CUDA device; pass "
                               "device='cpu' to train on the CPU with the kernels' plain versions")
        self.model = (model if model is not None else build_model(cfg)).to(self.device)
        self.criterion = build_criterion(cfg)
        self.optimizer, self.scheduler = build_optimizer(cfg, self.model)
        self.clip_gradients = build_gradient_clipper(cfg)
        self.dn_group_bucket = int(cfg.TPU.DN_GROUP_BUCKET)
        self.train_loader = train_loader
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.checkpoint_period = cfg.SOLVER.CHECKPOINT_PERIOD
        self.output_dir = cfg.OUTPUT_DIR
        self.generator = torch.Generator(device=self.device).manual_seed(max(cfg.SEED, 0))
        self.iteration = 0

    # -- checkpoints -------------------------------------------------------
    def _checkpoint_dir(self) -> str:
        return os.path.join(self.output_dir, "checkpoints")

    def save(self, step: int) -> str:
        os.makedirs(self._checkpoint_dir(), exist_ok=True)
        path = os.path.join(self._checkpoint_dir(), f"model_{step:07d}.pth")
        torch.save({"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                    "scheduler": self.scheduler.state_dict(), "iteration": step,
                    "generator": self.generator.get_state()}, path)
        with open(os.path.join(self._checkpoint_dir(), "last_checkpoint"), "w") as f:
            f.write(os.path.basename(path))
        # the last 3, as the JAX trainer's max_to_keep=3
        for old in sorted(glob.glob(os.path.join(self._checkpoint_dir(), "model_*.pth")))[:-3]:
            os.remove(old)
        return path

    def resume_or_load(self, resume: bool = True) -> int:
        """d2's resume_or_load: continue from the last checkpoint under
        OUTPUT_DIR where there is one, else load `MODEL.WEIGHTS` (a reference
        `.pth`, or a backbone's `.pkl`, partially, with the counts logged), or
        keep the fresh initialization with a warning where the weights are not
        found locally; returns the iteration to start from."""
        last = os.path.join(self._checkpoint_dir(), "last_checkpoint")
        if resume and os.path.isfile(last):
            with open(last) as f:
                path = os.path.join(self._checkpoint_dir(), f.read().strip())
            state = torch.load(path, map_location=self.device, weights_only=True)
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            self.scheduler.load_state_dict(state["scheduler"])
            self.generator.set_state(state["generator"].cpu())
            self.iteration = int(state["iteration"])
            logger.info("resumed from %s", path)
        elif self.cfg.MODEL.WEIGHTS:
            weights = self.cfg.MODEL.WEIGHTS
            local = locate_weights(weights)
            if local is None:
                # the JAX trainer's allow_fresh_init=True: training from scratch is
                # a meaningful run, evaluating a fresh model is not (Predictor raises)
                logger.warning("MODEL.WEIGHTS %s not found locally (download it or point "
                               "MODEL.WEIGHTS at a file); keeping the fresh initialization",
                               weights)
            else:
                counts = load_weights(self.model, load_state_dict_file(local), strict=False)
                logger.info("loaded weights from %s: %s", local, counts)
        return self.iteration

    # -- the loop ------------------------------------------------------------
    def run_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        metrics = train_step(self.model, self.criterion, self.optimizer, self.scheduler,
                             batch.to(self.device, non_blocking=True), self.generator,
                             clip_gradients=self.clip_gradients,
                             dn_group_bucket=self.dn_group_bucket)
        self.iteration += 1
        return metrics

    def train(self, start_iter: Optional[int] = None,
              hooks: Optional[Dict[str, Callable]] = None) -> None:
        """Steps `start_iter` (by default where the trainer stands) to
        SOLVER.MAX_ITER. After each step: a metrics line every 20 steps and
        at the end, `hooks` called as `h(step, trainer)`, a checkpoint every
        SOLVER.CHECKPOINT_PERIOD steps and at the end, an evaluation every
        TEST.EVAL_PERIOD steps."""
        if start_iter is not None:
            self.iteration = start_iter
        os.makedirs(self.output_dir, exist_ok=True)
        metrics_path = os.path.join(self.output_dir, "metrics.json")
        loader = self.train_loader
        if loader is None:
            loader = build_train_loader(self.cfg, pin_memory=self.device.type == "cuda")
        try:
            batches = iter(loader)
            first, t_data = self.iteration, 0.0
            while self.iteration < self.max_iter:
                step = self.iteration
                t0 = time.perf_counter()
                batch = next(batches)
                t_data += time.perf_counter() - t0
                metrics = self.run_step(batch)
                if step % 20 == 0 or step == self.max_iter - 1:
                    line = {k: float(v) for k, v in metrics.items()}
                    line["iteration"] = step
                    line["lr"] = self.scheduler.get_last_lr()[-1]
                    # mean seconds a step waited for its batch
                    line["data_time"] = t_data / (step - first + 1)
                    logger.info("iter %d total_loss %.4f loss_ce %.4f loss_mask %.4f "
                                "loss_dice %.4f data_time %.4f", step, line["total_loss"],
                                line.get("loss_ce", 0.0), line.get("loss_mask", 0.0),
                                line.get("loss_dice", 0.0), line["data_time"])
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps(line) + "\n")
                for hook in (hooks or {}).values():
                    hook(step, self)
                if (step + 1) % self.checkpoint_period == 0 and step + 1 < self.max_iter:
                    self.save(step + 1)
                eval_period = self.cfg.TEST.EVAL_PERIOD
                if eval_period and (step + 1) % eval_period == 0:
                    self.test(max_images=self.cfg.TEST.get("MAX_EVAL_IMAGES"))
            self.save(self.max_iter)
        finally:
            if loader is not self.train_loader:
                loader.close()

    def test(self, max_images: Optional[int] = None) -> Optional[Dict]:
        """Evaluate every dataset of DATASETS.TEST (d2's Trainer.test,
        `mp_former_tpu/engine/trainer.py:253-287`): results keyed as the
        evaluators key them (by dataset name where there are several), None
        when nothing was evaluated. A dataset without an evaluator in the port
        is logged and skipped. The model keeps its train/eval mode."""
        from ..data.catalog import DatasetCatalog
        from ..data.datasets import builtin  # noqa: F401  (registration)
        from .eval_loop import run_evaluation

        names = self.cfg.DATASETS.TEST
        results = {}
        mode = self.model.training
        try:
            with torch.no_grad():
                for name in names:
                    if name not in DatasetCatalog:
                        logger.warning("eval dataset %s not registered; skipping", name)
                        continue
                    try:
                        r = run_evaluation(self.cfg, self.model, name, max_images)
                    except NotImplementedError as e:
                        logger.warning("%s", e)
                        continue
                    results.update(r if len(names) == 1 else {name: r})
        finally:
            self.model.train(mode)
        logger.info("eval results: %s", results)
        return results or None
