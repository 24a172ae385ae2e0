"""CUDA packed row gather ``out[i] = table[idx[i]]``
(``csrc/packed_gather.cu``).

The port of ``repro/kernels/packed_gather.py::packed_gather_rows``
(``pl.pallas_call`` at :77); its wrapper contract is
``repro/kernels/ops.py:539-555`` less the sort: the CUDA kernel reads any
row at full width, so the order of ``idx`` is free and nothing is
un-permuted. Indices clamp as jnp indexing clamps them (a negative index
counts from the end).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check, stream_ptr

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: N, M, the row's bytes and the grid cross as 64-bit integers, and the
#: kernel's offsets are 64-bit too
KERNEL = CudaKernel(
    "packed_gather", replaces="src/repro/kernels/packed_gather.py:77",
    funcs={"packed_gather_rows": [_P, _P, _P, _LL, _LL, _LL, _I, _I, _LL,
                                  _P]})

PACK = 8                    # rows per block (csrc/packed_gather.cu PACK)
MAX_GRID_X = 2 ** 31 - 1    # gridDim.x limit
ROW_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
INDEX_DTYPES = (torch.int32, torch.int64)


def launch_geometry(M: int) -> int:
    """gridDim.x: ``ceil(M / PACK)`` blocks, block ``i`` writing output
    rows ``i * PACK`` onward."""
    return -(-M // PACK)


def copy_unit(row_bytes: int, *addresses: int) -> int:
    """The kernel's copy width in bytes: 16 (one uint4) where the row's
    byte width and every base address allow it, else the widest of 8, 4, 2
    and 1 that does."""
    return next(unit for unit in (16, 8, 4, 2, 1)
                if row_bytes % unit == 0
                and all(a % unit == 0 for a in addresses))


def validate(table: torch.Tensor, idx: torch.Tensor) -> None:
    """The shapes, types and layout the kernel takes (any device)."""
    check(table.dim() == 2 and idx.dim() == 1,
          f"packed_gather_rows: table {tuple(table.shape)}, idx "
          f"{tuple(idx.shape)}; expected an (N, D) table and (M,) indices")
    check(table.numel() > 0 and idx.numel() > 0,
          "packed_gather_rows: empty operand")
    check(table.dtype in ROW_DTYPES,
          f"packed_gather_rows: table dtype {table.dtype}; expected one of "
          f"{ROW_DTYPES}")
    check(idx.dtype in INDEX_DTYPES,
          f"packed_gather_rows: idx dtype {idx.dtype}; expected int32 or "
          "int64")
    check(table.is_contiguous() and idx.is_contiguous(),
          "packed_gather_rows: operands must be contiguous")
    check(table.device == idx.device,
          "packed_gather_rows: table and idx on different devices")
    check(launch_geometry(idx.shape[0]) <= MAX_GRID_X,
          "packed_gather_rows: ceil(M / 8) exceeds gridDim.x")


def packed_gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor
                            ) -> torch.Tensor:
    """table (N, D) bf16 / fp16 / fp32 and idx (M,) int32 / int64 on the
    card -> (M, D) in table's dtype."""
    check(table.is_cuda, "packed_gather_rows: table must be on a CUDA device")
    validate(table, idx)
    N, D = table.shape
    M = idx.shape[0]
    out = torch.empty((M, D), dtype=table.dtype, device=table.device)
    row_bytes = D * table.element_size()
    KERNEL.launch("packed_gather_rows", table.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), N, M, row_bytes, idx.element_size(),
                  copy_unit(row_bytes, table.data_ptr(), out.data_ptr()),
                  launch_geometry(M), stream_ptr(table))
    return out
