"""CUDA diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t``
(``csrc/lru_scan.cu``).

The port of ``repro/kernels/lru_scan.py`` (``pl.pallas_call`` at :49); its
wrapper contract is ``repro/kernels/ops.py:477-510`` less the padding: the
CUDA kernel masks the ragged edge of D itself and walks any L.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check, stream_ptr

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
#: B, L, D and the grid cross as 64-bit integers: B * L * D passes 2^31 at
#: B = 64, L = 256, D = 131072, and the kernel's offsets are 64-bit too
KERNEL = CudaKernel(
    "lru_scan", replaces="src/repro/kernels/lru_scan.py:49",
    funcs={"lru_scan_f32": [_P, _P, _P, _LL, _LL, _LL, _LL, _P]})

THREADS = 256               # channels per block (csrc/lru_scan.cu THREADS)
MAX_GRID_X = 2 ** 31 - 1    # gridDim.x limit


def launch_geometry(B: int, D: int) -> int:
    """gridDim.x: ``ceil(D / THREADS)`` channel tiles per batch row, rows
    one after another; block ``i`` covers row ``i // tiles`` and channels
    ``(i % tiles) * THREADS`` onward."""
    return B * -(-D // THREADS)


def validate(a: torch.Tensor, b: torch.Tensor) -> None:
    """The shapes, type and layout the kernel takes (any device)."""
    check(a.dim() == 3 and a.shape == b.shape,
          f"lru_scan: a {tuple(a.shape)}, b {tuple(b.shape)}; expected two "
          "(B, L, D) tensors of one shape")
    check(a.numel() > 0, "lru_scan: empty operand")
    check(a.dtype == b.dtype == torch.float32,
          f"lru_scan: float32 operands only, got {a.dtype} and {b.dtype}")
    check(a.is_contiguous() and b.is_contiguous(),
          "lru_scan: operands must be contiguous")
    check(launch_geometry(a.shape[0], a.shape[2]) <= MAX_GRID_X,
          "lru_scan: B * ceil(D / 256) exceeds gridDim.x")


def lru_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, L, D) float32 on the card -> h (B, L, D) float32, from a
    zero state."""
    check(a.is_cuda and b.device == a.device,
          "lru_scan: a and b must be on one CUDA device")
    validate(a, b)
    B, L, D = a.shape
    h = torch.empty_like(a)
    KERNEL.launch("lru_scan_f32", a.data_ptr(), b.data_ptr(), h.data_ptr(),
                  B, L, D, launch_geometry(B, D), stream_ptr(a))
    return h
