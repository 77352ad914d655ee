import contextlib

import torch

from .registry import (
    Registry,
    META_ARCH_REGISTRY,
    BACKBONE_REGISTRY,
    SEM_SEG_HEADS_REGISTRY,
    PIXEL_DECODER_REGISTRY,
    TRANSFORMER_DECODER_REGISTRY,
    DATASET_MAPPER_REGISTRY,
)
from .shape_spec import ShapeSpec
from .interp import resize


def compute_dtype(cfg) -> torch.dtype:
    """cfg.TPU.COMPUTE_DTYPE -> torch dtype, by the JAX package's rule
    (`mp_former_tpu/utils/__init__.py:15-19`): "bfloat16" is the
    AMP-equivalent switch, anything else is float32."""
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


def compute_region(device_type: str, dtype: torch.dtype):
    """The region a model computes in: `torch.autocast(device_type, dtype)`
    for bfloat16 (linears, convolutions and matmuls in bfloat16, parameters
    float32), nothing for float32. The same code serves CPU and CUDA tensors."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type, dtype=dtype)


def float32_region(device_type: str):
    """A float32 island inside a compute region: autocast off, so operations
    run in their inputs' types, as the JAX package's modules without a
    `dtype=` do."""
    return torch.autocast(device_type, enabled=False)


def region_dtype(device_type: str) -> torch.dtype:
    """The compute type of the region open on `device_type` (float32 outside
    one): what the JAX package's `dtype=` of a module is at that point."""
    if torch.is_autocast_enabled(device_type):
        return torch.get_autocast_dtype(device_type)
    return torch.float32
