"""The demo's predictors (reference demo/predictor.py; the port's twin of the
JAX package's `demo/predictor.py`):

- `Predictor`, the DefaultPredictor role: cfg -> model and weights on
  MODEL.DEVICE (the card unless `cpu`), one BGR image in, the instance and
  semantic outputs at its size out; `forward_raw` is the raw forward every
  demo pipeline shares. It serves through `engine/predictor.py`: one forward
  a request, K1 6 and K3 9 launches on the card with the released decoder.
- `AsyncPredictor` (reference :131-220): the same put / get queue, with the
  device's work on a background thread, so that a caller's host work
  (decoding, drawing) overlaps it; results come back in submit order.
- `VisualizationDemo` (reference :17-128): `run_on_image`, `run_on_video`.

Without MODEL.WEIGHTS the model keeps its reference init drawn from seed 0,
as the JAX demo initialises from `PRNGKey(0)`.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..config import cfg_device
from ..engine.predictor import Predictor as EnginePredictor
from .overlay import overlay_instances, overlay_semantic


class Predictor:
    """cfg (+ MODEL.WEIGHTS) -> callable(image_bgr) -> {"instances": {"scores",
    "classes", "masks"}, "sem_seg": (K, H, W) probabilities}, as
    MASK_FORMER.TEST's INSTANCE_ON and SEMANTIC_ON say. `engine` is the
    serving predictor underneath (every task, `is_thing` for the panoptic
    fusion)."""

    def __init__(self, cfg, device=None, is_thing: Optional[np.ndarray] = None):
        self.cfg = cfg
        device = cfg_device(cfg) if device is None else device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.engine = EnginePredictor(cfg, device=device, is_thing=is_thing)
        t = cfg.MODEL.MASK_FORMER.TEST
        self.tasks = [task for task, on in (("instance", t.INSTANCE_ON),
                                            ("semantic", t.SEMANTIC_ON)) if on]

    def forward_raw(self, image_bgr: np.ndarray):
        """(logits (Q, K+1), mask logits (Q, h4, w4), resized (h, w) before
        padding) as float32 host arrays: the shared eval preprocessing
        (shortest edge to MIN_SIZE_TEST, MAX_SIZE_TEST cap, INPUT.FORMAT order,
        mean padding to a multiple of 32) and one forward."""
        logits, masks, image_size = self.engine.forward_raw(image_bgr)
        return logits.float().cpu().numpy(), masks.float().cpu().numpy(), image_size

    def __call__(self, image_bgr: np.ndarray) -> dict:
        return self.engine(image_bgr, tasks=self.tasks)


class AsyncPredictor:
    """put() / get() frame pipeline (reference AsyncPredictor :131-220): one
    background thread owns the device; results come back in submit order."""

    _STOP = object()

    def __init__(self, cfg):
        self.predictor = Predictor(cfg)
        self._tasks: "queue.Queue" = queue.Queue(maxsize=3)  # the reference's 3 a worker
        self._results: "queue.Queue" = queue.Queue()
        self._submitted = 0
        self._returned = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while True:
            item = self._tasks.get()
            if item is self._STOP:
                return
            try:
                self._results.put(self.predictor(item))
            except Exception as e:  # raised again by get()
                self._results.put(e)

    def put(self, image_bgr: np.ndarray) -> None:
        self._tasks.put(image_bgr)
        self._submitted += 1

    def get(self) -> dict:
        res = self._results.get()
        self._returned += 1
        if isinstance(res, Exception):
            raise res
        return res

    def __len__(self) -> int:
        """Frames in flight (submitted, not yet returned)."""
        return self._submitted - self._returned

    def shutdown(self) -> None:
        self._tasks.put(self._STOP)
        self._thread.join()

    def __call__(self, image_bgr: np.ndarray) -> dict:
        self.put(image_bgr)
        return self.get()


class VisualizationDemo:
    """Images and frame sequences drawn with their predictions (reference
    VisualizationDemo :17-128)."""

    def __init__(self, cfg, parallel: bool = False):
        self.cfg = cfg
        self.predictor = AsyncPredictor(cfg) if parallel else Predictor(cfg)
        self.threshold = 0.5

    def draw(self, image_bgr: np.ndarray, predictions: dict,
             class_names: Optional[Sequence[str]] = None) -> np.ndarray:
        inst = predictions.get("instances")
        if inst is not None and len(inst["scores"]):
            return overlay_instances(image_bgr, inst["scores"], inst["classes"], inst["masks"],
                                     class_names, self.threshold)
        if "sem_seg" in predictions:
            return overlay_semantic(image_bgr, predictions["sem_seg"])
        return image_bgr.copy()

    def run_on_image(self, image_bgr: np.ndarray, class_names=None):
        predictions = self.predictor(image_bgr)
        return predictions, self.draw(image_bgr, predictions, class_names)

    def run_on_video(self, frames: Iterable[np.ndarray], class_names=None,
                     max_frames: Optional[int] = None):
        """(predictions, drawn frame) for each BGR frame of `frames`, at most
        `max_frames`; with an AsyncPredictor up to 5 frames are in flight
        (the reference's put-ahead buffer)."""
        def capped():
            for i, frame in enumerate(frames):
                if max_frames is not None and i >= max_frames:
                    return
                yield frame

        if not isinstance(self.predictor, AsyncPredictor):
            for frame in capped():
                predictions = self.predictor(frame)
                yield predictions, self.draw(frame, predictions, class_names)
            return
        inflight = collections.deque()
        for frame in capped():
            inflight.append(frame)
            self.predictor.put(frame)
            if len(inflight) >= 5:
                f = inflight.popleft()
                predictions = self.predictor.get()
                yield predictions, self.draw(f, predictions, class_names)
        while inflight:
            f = inflight.popleft()
            predictions = self.predictor.get()
            yield predictions, self.draw(f, predictions, class_names)
