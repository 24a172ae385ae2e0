"""CUDA tiled GEMM with a fused epilogue (``csrc/gemm.cu``).

The port of ``repro/kernels/gemm.py`` (``pl.pallas_call`` at :101); its
wrapper contract is ``repro/kernels/ops.py:98``, less the padding: the CUDA
kernel masks the ragged edges of M, N and K itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check, stream_ptr

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "gemm", replaces="src/repro/kernels/gemm.py:101",
    funcs={"gemm_bf16": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P]})

BLOCK_M = BLOCK_N = 64     # output tile of one block (csrc/gemm.cu BM, BN)
ACTS = {None: 0, "silu": 1, "gelu": 2}


def launch_geometry(M: int, N: int) -> tuple[int, int]:
    """Grid (x over N tiles, y over M tiles) covering every output once."""
    return -(-N // BLOCK_N), -(-M // BLOCK_M)


def validate(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
             act: str | None) -> None:
    """The shapes, layout and epilogue the kernel takes (any device)."""
    check(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
          f"gemm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    check(x.numel() > 0 and w.numel() > 0, "gemm: empty operand")
    check(x.is_contiguous() and w.is_contiguous(), "gemm: operands must be "
          "contiguous row-major")
    check(act in ACTS, f"gemm: act {act!r}")
    if bias is not None:
        check(bias.shape == (w.shape[1],) and bias.is_contiguous(),
              "gemm: bias must be a contiguous (N,) tensor")


def gemm_cuda(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor | None = None, *, scale: float = 1.0,
              act: str | None = None,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (M, K) @ w (K, N), bf16 on the card; epilogue ``*scale``,
    ``+bias`` (N,), activation, cast to ``out_dtype`` (bf16 or float32,
    default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    check(x.is_cuda and w.device == x.device
          and (bias is None or bias.device == x.device),
          "gemm: operands must be on one CUDA device")
    check(x.dtype == w.dtype == torch.bfloat16
          and (bias is None or bias.dtype == torch.bfloat16),
          f"gemm: bf16 operands only, got {x.dtype} and {w.dtype}")
    check(out_dtype in (torch.bfloat16, torch.float32),
          f"gemm: out_dtype {out_dtype}")
    validate(x, w, bias, act)
    M, N, K = x.shape[0], w.shape[1], x.shape[1]
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    gx, gy = launch_geometry(M, N)
    KERNEL.launch("gemm_bf16", x.data_ptr(), w.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  M, N, K, float(scale), ACTS[act],
                  int(out_dtype == torch.float32), gx, gy, stream_ptr(x))
    return out
