"""The trainer (`mp_former_tpu/engine/trainer.py:60-287`): builds model,
criterion, optimizer and schedule from a cfg, loops `train_step` over the
batches of `data/loader.py::build_train_loader` (or of an iterator the caller
passes, e.g. `data/synthetic.py`), writes `metrics.json` lines with the
reference's loss keys and `data_time`, calls hooks, evaluates every
TEST.EVAL_PERIOD steps (`test`), saves and resumes with `torch.save`, keeping
the last 3 checkpoints. `TPU.GRAD_ACCUM_STEPS` splits each step into that many
micro-batches (`train_step.py`). With `TPU.PROFILE_DIR` set, steps start+5 to
start+7 of a `train()` call run under `torch.profiler` (the JAX trainer's
trace window, `mp_former_tpu/engine/trainer.py:202-205`), exported as a Chrome
trace into that directory. It runs on `cuda` unless the caller passes
`device="cpu"`, and raises when asked for `cuda` and there is none.

A video model trains through the same loop (`mp_former_tpu/engine/trainer.py:61-75`):
the caller passes its criterion (`video/criterion.py:build_video_criterion`)
and a loader of clips (`video/ytvis.py:build_clip_loader`), and `test`
scores tube AP with the whole-clip loop (`:259-276`).

In a process group of W ranks (`parallel/dist.py:launch`) the model is
wrapped in DDP (also where W is 1), each rank takes its block of
SOLVER.IMS_PER_BATCH / W rows of every global batch (the cfg's loader does;
a loader the caller passes must), and a step is the one-process step on the
global batch (`train_step.py`).
Every rank seeds its generator alike and resumes from the same checkpoint;
rank 0 alone writes checkpoints and `metrics.json`, whose losses are the
global batch's; `test` shards the records over the ranks.
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
from ..parallel.dist import get_rank, get_world_size, is_main_process
from ..parallel.mesh import data_parallel_size
from ..structures import Batch
from .convert import load_state_dict_file, load_weights, locate_weights
from .optimizer import build_gradient_clipper, build_optimizer
from .train_step import train_step

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(self, cfg, train_loader: Optional[Iterable[Batch]] = None,
                 model: Optional[torch.nn.Module] = None, criterion=None,
                 device: Union[str, torch.device] = "cuda"):
        """`train_loader`: an iterable of `Batch`; None builds the cfg's
        loader at each `train()` call and closes it when the call ends.
        `model` and `criterion` default to the cfg's image model and
        `build_criterion(cfg)`."""
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda'): torch finds no CUDA device; pass "
                               "device='cpu' to train on the CPU with the kernels' plain versions")
        # training mode: MODEL.MASK_FORMER.DROPOUT acts (`build_model` returns `.eval()`)
        self.model = (model if model is not None else build_model(cfg)).to(self.device).train()
        self.criterion = criterion if criterion is not None else build_criterion(cfg)
        self.optimizer, self.scheduler = build_optimizer(cfg, self.model)
        self.clip_gradients = build_gradient_clipper(cfg)
        self.dn_group_bucket = int(cfg.TPU.DN_GROUP_BUCKET)
        self.accum = int(cfg.TPU.GRAD_ACCUM_STEPS or 1)
        self.world = data_parallel_size(cfg, get_world_size())
        if cfg.SOLVER.IMS_PER_BATCH % (self.world * self.accum):
            ranks = f"{self.world} ranks x " if self.world > 1 else ""
            raise ValueError(f"SOLVER.IMS_PER_BATCH={cfg.SOLVER.IMS_PER_BATCH} must be "
                             f"divisible by {ranks}TPU.GRAD_ACCUM_STEPS={self.accum}")
        # the module the step runs: DDP wherever a process group runs (one rank
        # of one card included)
        self.step_model = self.model
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            from torch.nn.parallel import DistributedDataParallel

            ids = [torch.cuda.current_device()] if self.device.type == "cuda" else None
            # a DN mode or a decoder variant may leave parameters without a gradient
            self.step_model = DistributedDataParallel(
                self.model, device_ids=ids, broadcast_buffers=False,
                find_unused_parameters=True)
        self.train_loader = train_loader
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.checkpoint_period = cfg.SOLVER.CHECKPOINT_PERIOD
        self.output_dir = cfg.OUTPUT_DIR
        self.generator = torch.Generator(device=self.device).manual_seed(max(cfg.SEED, 0))
        self.iteration = 0

    # -- checkpoints -------------------------------------------------------
    def _checkpoint_dir(self) -> str:
        return os.path.join(self.output_dir, "checkpoints")

    def save(self, step: int) -> Optional[str]:
        """Rank 0 writes `checkpoints/model_<step>.pth` (None on the others)."""
        if not is_main_process():
            return None
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
            if state.get("generator") is not None:  # a converted JAX run has none
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
    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof, self.iteration

    def _stop_profile(self, prof, first: int) -> str:
        prof.stop()
        profile_dir = self.cfg.TPU.PROFILE_DIR
        os.makedirs(profile_dir, exist_ok=True)
        rank = f"_rank{get_rank()}" if self.world > 1 else ""
        path = os.path.join(profile_dir,
                            f"steps_{first}-{self.iteration - 1}{rank}.pt.trace.json")
        prof.export_chrome_trace(path)
        logger.info("profiled steps %d-%d into %s", first, self.iteration - 1, path)
        return path

    def run_step(self, batch: Batch, stage: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """One step; `stage(name)`, where given, wraps each stage of it
        (`train_step`)."""
        metrics = train_step(self.step_model, self.criterion, self.optimizer, self.scheduler,
                             batch.to(self.device, non_blocking=True), self.generator,
                             clip_gradients=self.clip_gradients,
                             dn_group_bucket=self.dn_group_bucket, accum=self.accum, stage=stage)
        self.iteration += 1
        return metrics

    def train(self, start_iter: Optional[int] = None,
              hooks: Optional[Dict[str, Callable]] = None) -> None:
        """Steps `start_iter` (by default where the trainer stands) to
        SOLVER.MAX_ITER. After each step: a metrics line every 20 steps and
        at the end (losses, `lr`, `data_time`, `time`), `hooks` called as
        `h(step, trainer)`, a checkpoint every
        SOLVER.CHECKPOINT_PERIOD steps and at the end, an evaluation every
        TEST.EVAL_PERIOD steps. With TPU.PROFILE_DIR set, a profiler trace of
        the steps start+5 to start+7 (fewer where the run ends before)."""
        if start_iter is not None:
            self.iteration = start_iter
        os.makedirs(self.output_dir, exist_ok=True)
        metrics_path = os.path.join(self.output_dir, "metrics.json")
        loader = self.train_loader
        if loader is None:
            loader = build_train_loader(self.cfg, pin_memory=self.device.type == "cuda",
                                        rank=get_rank(), world_size=self.world)
        profiling = None  # (profiler, its first step) while a trace is recorded
        try:
            batches = iter(loader)
            first, t_data = self.iteration, 0.0
            last_line, t_line = self.iteration - 1, time.perf_counter()
            while self.iteration < self.max_iter:
                step = self.iteration
                if self.cfg.TPU.PROFILE_DIR and step == first + 5:
                    profiling = self._start_profile()
                if profiling is not None and step == first + 8:
                    self._stop_profile(*profiling)
                    profiling = None
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
                    # mean wall seconds a step since the last line: the batch wait,
                    # checkpoints and evaluations included (reading the losses above
                    # waits for the device)
                    now = time.perf_counter()
                    line["time"] = (now - t_line) / (step - last_line)
                    last_line, t_line = step, now
                    logger.info("iter %d total_loss %.4f loss_ce %.4f loss_mask %.4f "
                                "loss_dice %.4f data_time %.4f", step, line["total_loss"],
                                line.get("loss_ce", 0.0), line.get("loss_mask", 0.0),
                                line.get("loss_dice", 0.0), line["data_time"])
                    if is_main_process():
                        with open(metrics_path, "a") as f:
                            f.write(json.dumps(line) + "\n")
                for hook in (hooks or {}).values():
                    hook(step, self)
                if (step + 1) % self.checkpoint_period == 0 and step + 1 < self.max_iter:
                    self.save(step + 1)
                eval_period = self.cfg.TEST.EVAL_PERIOD
                if eval_period and (step + 1) % eval_period == 0:
                    self.test(max_images=self.cfg.TEST.get("MAX_EVAL_IMAGES"))
            if profiling is not None:
                self._stop_profile(*profiling)
                profiling = None
            self.save(self.max_iter)
        finally:
            if profiling is not None:
                profiling[0].stop()
            if loader is not self.train_loader:
                loader.close()

    def test(self, max_images: Optional[int] = None) -> Optional[Dict]:
        """Evaluate every dataset of DATASETS.TEST (d2's Trainer.test,
        `mp_former_tpu/engine/trainer.py:253-287`): results keyed as the
        evaluators key them (by dataset name where there are several), None
        when nothing was evaluated. A dataset without an evaluator in the port
        is logged and skipped. A `VideoMaskFormer` scores each dataset's clips
        whole with `video/eval_loop.py:inference_on_video_dataset` (tube AP
        under "segm"; `max_images` caps the clips). The model evaluates in
        `.eval()` mode and is put back in its own mode afterwards."""
        from ..data.catalog import DatasetCatalog
        from ..data.datasets import builtin  # noqa: F401  (registration)
        from ..models.meta_arch.video_maskformer import VideoMaskFormer
        from ..video.eval_loop import inference_on_video_dataset
        from .eval_loop import run_evaluation

        names = self.cfg.DATASETS.TEST
        results = {}
        mode = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for name in names:
                    if name not in DatasetCatalog:
                        logger.warning("eval dataset %s not registered; skipping", name)
                        continue
                    try:
                        if isinstance(self.model, VideoMaskFormer):
                            r = inference_on_video_dataset(
                                self.cfg, self.model, DatasetCatalog.get(name), max_images)
                        else:
                            r = run_evaluation(self.cfg, self.model, name, max_images)
                    except NotImplementedError as e:
                        logger.warning("%s", e)
                        continue
                    results.update(r if len(names) == 1 else {name: r})
        finally:
            self.model.train(mode)
        logger.info("eval results: %s", results)
        return results or None
