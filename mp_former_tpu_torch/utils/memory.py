"""Out-of-memory retry (reference mask2former_video/utils/memory.py:27-84
`retry_if_cuda_oom`; `mp_former_tpu/utils/memory.py`).

On an out-of-memory error the wrapped function runs once more after
`torch.cuda.empty_cache()`, on the card. The reference and the JAX package
then retry a second time on the CPU; the port does not, so that a run never
leaves the device without a word (ROADMAP §C): the second error is raised.
"""

from __future__ import annotations

import functools
import logging

import torch

logger = logging.getLogger(__name__)


def _is_oom(err: Exception) -> bool:
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    return "out of memory" in str(err).lower()


def retry_if_oom(fn):
    """Decorator: on an out-of-memory error, empty the CUDA cache and call
    `fn` once more; any other error, or a second one, is raised."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if not _is_oom(e):
                raise
            logger.warning("out of memory in %s; emptying the CUDA cache and retrying once",
                           fn.__name__)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            return fn(*args, **kwargs)

    return wrapped
