"""Processes, ranks and collectives (`mp_former_tpu/parallel/dist.py`; the
reference's d2 `launch` and `comm`, train_net.py:399-412).

Data parallelism is torch.distributed with one process a card, the
reference's own scheme (SURVEY section 2.8). `launch` spawns the processes
of one machine and joins them into a process group: NCCL where the ranks
own CUDA cards, gloo for `MODEL.DEVICE cpu`. Outside a process group every
helper here is the one-process identity, so each code path runs, and is
tested, in one process too.

`sharded_eval_loop` is the JAX file's evaluation loop without its device
batching (a rank is one card and runs one record at a time): the records
are capped before they are sharded round-robin over the ranks, and the
evaluators' states are gathered and merged at the end.
"""

from __future__ import annotations

import logging
import socket
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the rank of this process among the processes of its machine, set by `launch`
_LOCAL_RANK = 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_local_rank() -> int:
    return _LOCAL_RANK


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """A barrier over every rank; nothing in one process."""
    if get_world_size() > 1:
        dist.barrier()


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks (a new tensor; `x` itself in one process)."""
    if get_world_size() == 1:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


def all_gather_objects(obj: Any) -> List[Any]:
    """One picklable object a rank; every rank receives the list indexed by
    rank. `[obj]` in one process."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def sharded_eval_loop(records: Sequence[dict], evaluator, map_fn: Callable[[dict], Any],
                      process_fn: Callable[[Any], None],
                      max_records: Optional[int] = None) -> int:
    """The record loop that image and video evaluation share
    (`engine/eval_loop.py:run_evaluation`, `video/eval_loop.py`; d2's
    inference_on_dataset with its rank sharding and gather):

    - `max_records` caps the global record list before it is sharded, so
      the evaluated set is the same for any number of ranks;
    - rank r takes records r, r + W, ... (round-robin, the JAX file's rule);
    - `map_fn(rec)` gives an item, or None to skip the record (one that
      cannot be read); `process_fn(item)` runs the model and feeds
      `evaluator`;
    - at the end every rank's evaluator is gathered and merged into
      `evaluator` (`merge_from`), so that every rank holds the state of the
      whole record list.

    Returns the number of records this rank mapped."""
    if max_records is not None:
        records = records[:max_records]
    world, rank = get_world_size(), get_rank()
    mine = records[rank::world] if world > 1 else records
    done = 0
    for rec in mine:
        item = map_fn(rec)
        if item is None:
            continue
        done += 1
        process_fn(item)
    if world > 1:
        for i, other in enumerate(all_gather_objects(evaluator)):
            if i != rank:
                evaluator.merge_from(other)
    if max_records is not None and done < len(mine):
        # the cap counts raw records (the same set for any number of ranks), so
        # records the mapper skipped shrink the evaluated set below it
        logger.warning("evaluated %d of %d capped records (mapper skipped %d)",
                       done, len(mine), len(mine) - done)
    return done


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(local_rank: int, main: Callable, world_size: int, num_processes: int,
            machine_rank: int, dist_url: str, backend: str, args: tuple) -> None:
    global _LOCAL_RANK
    _LOCAL_RANK = local_rank
    if torch.cuda.is_available() and local_rank < torch.cuda.device_count():
        torch.cuda.set_device(local_rank)
    rank = machine_rank * num_processes + local_rank
    dist.init_process_group(backend, init_method=dist_url, world_size=world_size, rank=rank)
    try:
        synchronize()
        main(*args)
    finally:
        dist.destroy_process_group()


def launch(main: Callable, num_processes: int, num_machines: int = 1, machine_rank: int = 0,
           dist_url: str = "auto", args: tuple = (), backend: Optional[str] = None) -> None:
    """Run `main(*args)` in `num_processes` processes on this machine, ranks
    `machine_rank * num_processes` on, of `num_processes * num_machines` in
    all (d2's `launch`). One process in all calls `main` here, without a
    process group. `dist_url` "auto" takes a free TCP port of this machine
    (one machine only); `backend` None takes NCCL where CUDA is available,
    else gloo. Each process is bound to the card of its local rank where
    there is one. NCCL needs a card a process: asking for more processes than
    there are cards raises."""
    world_size = num_processes * num_machines
    if world_size == 1:
        main(*args)
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and num_processes > torch.cuda.device_count():
        raise ValueError(f"{num_processes} processes a machine over NCCL need as many CUDA "
                         f"cards; torch finds {torch.cuda.device_count()}")
    if dist_url == "auto":
        if num_machines != 1:
            raise ValueError("dist_url 'auto' serves one machine; give the first machine's "
                             "tcp://host:port for several")
        dist_url = f"tcp://127.0.0.1:{_free_port()}"
    torch.multiprocessing.start_processes(
        _worker, nprocs=num_processes, start_method="spawn",
        args=(main, world_size, num_processes, machine_rank, dist_url, backend, args))
