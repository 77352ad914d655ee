"""The reference's numeric regions: float32 throughout."""

import contextlib

import torch


def compute_dtype(cfg) -> torch.dtype:
    """The reference computes in float32 whatever the configuration asks."""
    return torch.float32


def compute_region(device_type: str, dtype: torch.dtype):
    return contextlib.nullcontext()


def float32_region(device_type: str):
    return torch.autocast(device_type, enabled=False)


def region_dtype(device_type: str) -> torch.dtype:
    return torch.float32
