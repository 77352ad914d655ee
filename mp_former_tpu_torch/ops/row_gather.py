"""Row gather and row gather-sum: the CUDA kernels and their plain versions.

`row_gather(tab, idx)` is `tab[idx]` for a 2-D table; `row_gather_sum(tab,
idx, slots)` adds row `idx[i]` into slot `i % slots`. On CUDA tensors they
launch `csrc/row_gather.cu`, the port of the JAX package's three row-gather
probes (`tools/bench_sampling_engines.py` `probe_mosaic_take` and
`probe_pallas_dma`, and the in-kernel gather of `tools/probe_msda_kernel.py`);
on CPU tensors they take the plain versions. `tools/probe_torch_row_gather.py`
times them.

Indices must lie in [0, R): the kernels do not check them.
"""

from __future__ import annotations

import torch

from .cuda_build import library

GATHER_DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int64)

# launches of each kernel since the last reset
GATHER_LAUNCHES = 0
SUM_LAUNCHES = 0


def row_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab (R, W), idx (N,) -> (N, W)."""
    return tab[idx]


def row_gather_sum_plain(tab: torch.Tensor, idx: torch.Tensor, slots: int) -> torch.Tensor:
    """tab (R, W), idx (N,) with N a multiple of `slots` -> (slots, W): row i
    is added into slot i % slots."""
    return tab[idx].view(-1, slots, tab.shape[1]).sum(0)


def _check(name: str, tab: torch.Tensor, idx: torch.Tensor, slots: int = 1) -> None:
    if tab.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: tab must be (R, W) and idx (N,), got {tuple(tab.shape)} "
                         f"and {tuple(idx.shape)}")
    if idx.dtype not in INDEX_DTYPES:
        raise TypeError(f"{name}: idx must be int32 or int64, got {idx.dtype}")
    if slots <= 0 or idx.shape[0] % slots:
        raise ValueError(f"{name}: N={idx.shape[0]} is not a multiple of slots={slots}")


def _check_cuda(name: str, tab: torch.Tensor, idx: torch.Tensor) -> None:
    if not (tab.is_cuda and idx.is_cuda and tab.device == idx.device):
        raise ValueError(f"{name}: tab and idx must be CUDA tensors on one device")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if tab.requires_grad:
        raise RuntimeError(f"{name} is forward-only: run it under torch.no_grad()")


def row_gather_fwd(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the gather kernel on CUDA tensors; raises on anything it does
    not take, and if the launch fails."""
    global GATHER_LAUNCHES
    _check("row_gather", tab, idx)
    _check_cuda("row_gather", tab, idx)
    if tab.dtype not in GATHER_DTYPES:
        raise TypeError(f"row_gather: tab must be float32 or bfloat16, got {tab.dtype}")
    n, width = idx.shape[0], tab.shape[1]
    out = torch.empty((n, width), dtype=tab.dtype, device=tab.device)
    err = library().row_gather(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, width * tab.element_size(),
        int(idx.dtype == torch.int64), torch.cuda.current_stream(tab.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_gather: kernel launch failed with cudaError {err}")
    GATHER_LAUNCHES += 1
    return out


def row_gather_sum_fwd(tab: torch.Tensor, idx: torch.Tensor, slots: int) -> torch.Tensor:
    """Launch the gather-sum kernel on CUDA tensors (float32 tables); raises
    on anything it does not take, and if the launch fails."""
    global SUM_LAUNCHES
    _check("row_gather_sum", tab, idx, slots)
    _check_cuda("row_gather_sum", tab, idx)
    if tab.dtype != torch.float32:
        raise TypeError(f"row_gather_sum: tab must be float32, got {tab.dtype}")
    n, width = idx.shape[0], tab.shape[1]
    out = torch.zeros((slots, width), dtype=torch.float32, device=tab.device)
    err = library().row_gather_sum(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, width, slots,
        int(idx.dtype == torch.int64), torch.cuda.current_stream(tab.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_gather_sum: kernel launch failed with cudaError {err}")
    SUM_LAUNCHES += 1
    return out


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab (R, W) float32/bfloat16, idx (N,) int32/int64 -> (N, W). CUDA
    tensors go to the kernel, CPU tensors to the plain version."""
    if tab.is_cuda:
        return row_gather_fwd(tab, idx)
    _check("row_gather", tab, idx)
    return row_gather_plain(tab, idx)


def row_gather_sum(tab: torch.Tensor, idx: torch.Tensor, slots: int) -> torch.Tensor:
    """tab (R, W) float32, idx (N,), N a multiple of `slots` -> (slots, W)."""
    if tab.is_cuda:
        return row_gather_sum_fwd(tab, idx, slots)
    _check("row_gather_sum", tab, idx, slots)
    return row_gather_sum_plain(tab, idx, slots)
