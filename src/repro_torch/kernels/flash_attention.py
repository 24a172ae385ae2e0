"""CUDA FlashAttention-2 forward (``csrc/flash_attention.cu``).

The port of ``repro/kernels/flash_attention.py`` (``pl.pallas_call`` at
:101); wrapper contract ``repro/kernels/ops.py:359``, less the padding: the
kernel masks ragged query and KV tiles itself.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaKernel, check, stream_ptr

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "flash_attention", replaces="src/repro/kernels/flash_attention.py:101",
    funcs={"flash_attention_bf16":
           [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]})

BLOCK_Q, BLOCK_KV = 32, 64   # csrc/flash_attention.cu BQ, BKV
HEAD_DIMS = (64, 128)


def launch_geometry(BH: int, Sq: int) -> tuple[int, int]:
    """Grid (query head, query tile of BLOCK_Q rows)."""
    return BH, -(-Sq // BLOCK_Q)


def kv_tile_range(q0: int, Sq: int, Skv: int, *, causal: bool, window: int,
                  kv_len: int) -> tuple[int, int]:
    """KV tiles ``[lo, hi)`` that the query tile starting at row ``q0`` walks:
    exactly those holding a key some row of the tile may see (a key below
    ``kv_len``, not after the row when causal, within the window). The
    CUDA kernel computes the same bounds; every other tile is fully masked
    and never loaded."""
    q_last = min(q0 + BLOCK_Q, Sq) - 1
    hi_key = min(kv_len, Skv) - 1
    if causal:
        hi_key = min(hi_key, q_last)
    lo_key = max(0, q0 - window + 1) if window > 0 else 0
    lo = lo_key // BLOCK_KV
    return lo, (hi_key // BLOCK_KV + 1 if hi_key >= lo_key else lo)


def validate(q, k, v, *, window: int, kv_len: int) -> None:
    """The shapes, layout and masks the kernel takes (any device)."""
    check(q.dim() == 3 and k.dim() == 3 and k.shape == v.shape
          and q.shape[2] == k.shape[2],
          f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
          f"v {tuple(v.shape)}")
    BH, Sq, _ = q.shape
    BK, Skv, _ = k.shape
    check(BK > 0 and BH % BK == 0, f"flash_attention: BH {BH} % BK {BK}")
    check(Sq > 0 and Skv > 0 and 0 <= kv_len <= Skv and window >= 0,
          "flash_attention: empty sequence or kv_len/window out of range")
    check(all(t.is_contiguous() for t in (q, k, v)),
          "flash_attention: operands must be contiguous")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         cap: float = 0.0, scale: float | None = None,
                         kv_len: int = 0) -> torch.Tensor:
    """q (BH, Sq, D), k and v (BK, Skv, D), bf16 with BH % BK == 0.
    ``kv_len`` (0 = Skv) is the true KV length. Returns (BH, Sq, D)."""
    check(q.is_cuda and k.device == q.device and v.device == q.device,
          "flash_attention: q, k, v must be on one CUDA device")
    check(q.dtype == k.dtype == v.dtype == torch.bfloat16,
          "flash_attention: bf16 operands only")
    validate(q, k, v, window=window, kv_len=kv_len)
    BH, Sq, D = q.shape
    BK, Skv, _ = k.shape
    check(D in HEAD_DIMS, f"flash_attention: head dim {D}, supported "
          f"{HEAD_DIMS}")
    check(all(t.data_ptr() % 4 == 0 for t in (q, k, v)),
          "flash_attention: operands must be 4-byte aligned")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    grid_x, grid_y = launch_geometry(BH, Sq)
    KERNEL.launch("flash_attention_bf16", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), Sq, Skv, D, BH // BK,
                  kv_len or Skv, int(causal), int(window), float(scale),
                  float(cap), grid_x, grid_y, stream_ptr(q))
    return out
