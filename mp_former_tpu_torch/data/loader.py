"""The training loader (`mp_former_tpu/data/loader.py`; d2's
build_detection_train_loader in the reference).

A producer thread draws records in a seeded endless shuffle, maps them
through the dataset mapper on worker threads while the device computes the
previous step, groups the samples by image shape and puts batches into a
prefetch queue. A batch is a `structures.Batch` of CPU tensors (uint8
images, int64 labels, bool masks at the mapper's stride, float32 boxes, bool
valid), pinned where the trainer copies it to a CUDA device, so that the copy
can run without blocking. The JAX package's bit-packing collate serves its
runtime's host link and is not ported.
"""

from __future__ import annotations

import functools
import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..structures import Batch, Targets

logger = logging.getLogger(__name__)


def collate(samples: List[Dict], pin_memory: bool = False) -> Batch:
    def stack(key, dtype):
        t = torch.from_numpy(np.stack([s[key] for s in samples]).astype(dtype, copy=False))
        return t.pin_memory() if pin_memory else t

    return Batch(stack("image", np.uint8),
                 Targets(stack("labels", np.int64), stack("masks", bool),
                         stack("boxes", np.float32), stack("valid", bool)))


class TrainLoader:
    """Infinite shuffled loader with worker threads and a prefetch queue."""

    def __init__(self, records: List[dict], mapper: Callable, batch_size: int,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 filter_empty: bool = True, collate_fn: Optional[Callable] = None,
                 pin_memory: bool = False):
        self.records = records
        self.mapper = mapper
        self.collate = collate_fn or functools.partial(collate, pin_memory=pin_memory)
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.filter_empty = filter_empty
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _sample_stream(self) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed)
        order = np.arange(len(self.records))
        while True:
            rng.shuffle(order)
            for i in order:
                yield self.records[int(i)]

    def _put(self, item) -> bool:
        """Queue `item`, waiting for room; False once `close()` was called
        (a thread blocked in a plain `put` would never see the stop)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            self._produce_loop()
        except Exception as e:  # surfaced in __next__, so the consumer does not hang
            self._put(e)

    def _produce_loop(self):
        rng_master = np.random.RandomState(self.seed + 1)
        stream = self._sample_stream()
        pool = ThreadPoolExecutor(self.num_workers)
        try:
            pending: List = []
            # samples grouped by image shape (d2's aspect-ratio grouping):
            # mixed canvas sizes must not meet in one np.stack
            groups: Dict[tuple, List[Dict]] = {}
            while not self._stop.is_set():
                while len(pending) < self.batch_size * 2:
                    rec = next(stream)
                    seed = int(rng_master.randint(0, 2 ** 31 - 1))
                    pending.append(pool.submit(self.mapper, rec, np.random.RandomState(seed)))
                ready: List[Dict] = []
                rest: List = []
                for f in pending:
                    if len(ready) >= self.batch_size:
                        rest.append(f)
                        continue
                    s = f.result()
                    if s is None:
                        continue
                    if self.filter_empty and not s["valid"].any():
                        continue
                    ready.append(s)
                pending = rest
                for s in ready:
                    key = tuple(np.asarray(s["image"]).shape)
                    groups.setdefault(key, []).append(s)
                    # last-append order: a group still filling is not the
                    # eviction victim below
                    groups[key] = groups.pop(key)
                    if len(groups[key]) == self.batch_size:
                        if not self._put(self.collate(groups.pop(key))):
                            return
                # rare canvas shapes must not pool samples forever: keep at
                # most 16 groups, dropping the one that went longest without a
                # sample (LSJ mappers emit one shape; a safety valve for others)
                while len(groups) > 16:
                    stale = next(iter(groups))
                    dropped = groups.pop(stale)
                    logger.warning("dropping %d pooled samples of rare canvas shape %s "
                                   "(more than 16 distinct shapes in flight)",
                                   len(dropped), stale)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise RuntimeError("TrainLoader producer thread died (mapper/collate error)") from item
        return item

    def close(self, timeout: float = 10.0) -> None:
        """Stop the producer and wait for it (at most `timeout` seconds: a
        mapper call in flight finishes first)."""
        self._stop.set()
        self._thread.join(timeout)


def build_train_loader(cfg, pin_memory: bool = False) -> TrainLoader:
    """Reference Trainer.build_train_loader (train_net.py:224-248): records
    of DATASETS.TRAIN[0] through the mapper INPUT.DATASET_MAPPER_NAME names."""
    from ..utils.registry import DATASET_MAPPER_REGISTRY
    from . import dataset_mappers  # noqa: F401  (registration)
    from .catalog import DatasetCatalog
    from .datasets import builtin  # noqa: F401  (registration)

    records = DatasetCatalog.get(cfg.DATASETS.TRAIN[0])
    mapper_cls = DATASET_MAPPER_REGISTRY.get(cfg.INPUT.DATASET_MAPPER_NAME)
    mapper = mapper_cls(cfg, is_train=True, max_instances=cfg.TPU.MAX_INSTANCES)
    return TrainLoader(
        records, mapper, cfg.SOLVER.IMS_PER_BATCH, seed=max(cfg.SEED, 0),
        num_workers=cfg.DATALOADER.NUM_WORKERS,
        filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS, pin_memory=pin_memory)
