"""CUDA weight-only quantized GEMM (``csrc/gemm_wq.cu``).

The port of ``repro/kernels/gemm_wq.py`` (``pl.pallas_call`` at :135);
wrapper contract ``repro/kernels/ops.py:130-163``, less the padding and the
K-tile gather of scale rows: the kernel applies each element's block scale
as it stages the weight tile, so tiles may straddle quant blocks, and it
masks ragged M, N and K itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check, stream_ptr
from repro_torch.kernels.gemm import ACTS, launch_geometry

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "gemm_wq", replaces="src/repro/kernels/gemm_wq.py:135",
    funcs={"gemm_wq": [_P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _F, _I,
                       _I, _I, _I, _P]})

#: csrc/gemm_wq.cu CODE of each code layout
INT8, FP8, INT4 = 0, 1, 2

__all__ = ["KERNEL", "gemm_wq_cuda", "launch_geometry", "validate"]


def validate(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
             bias: torch.Tensor | None, act: str | None) -> tuple[int, int]:
    """The shapes, layout and epilogue the kernel takes (any device).
    Returns ``(code, qb)``: the code layout (``INT4`` when ``qw`` is int8
    with half of x's K rows) and the quant-block length ``K // nb``."""
    check(x.dim() == 2 and qw.dim() == 2 and scales.dim() == 2,
          f"gemm_wq: shapes x {tuple(x.shape)}, qw {tuple(qw.shape)}, "
          f"scales {tuple(scales.shape)}")
    M, K = x.shape
    N = qw.shape[1]
    check(qw.dtype in (torch.int8, torch.float8_e4m3fn),
          f"gemm_wq: codes must be int8 or float8_e4m3fn, got {qw.dtype}")
    if qw.shape[0] == K:
        code = INT8 if qw.dtype == torch.int8 else FP8
    else:
        check(qw.shape[0] * 2 == K and qw.dtype == torch.int8,
              f"gemm_wq: qw {tuple(qw.shape)} holds neither K={K} rows nor "
              "K/2 rows of packed int4")
        code = INT4
    nb = scales.shape[0]
    check(M > 0 and N > 0 and K > 0 and nb > 0 and K % nb == 0
          and scales.shape[1] == N,
          f"gemm_wq: scales {tuple(scales.shape)} must be (nb, {N}) with "
          f"nb | K={K}")
    qb = K // nb
    check(code != INT4 or qb % 2 == 0,
          f"gemm_wq: int4 needs an even quant block, got {qb}")
    check(all(t.is_contiguous() for t in (x, qw, scales)),
          "gemm_wq: operands must be contiguous row-major")
    check(act in ACTS, f"gemm_wq: act {act!r}")
    if bias is not None:
        check(bias.shape == (N,) and bias.is_contiguous(),
              "gemm_wq: bias must be a contiguous (N,) tensor")
    return code, qb


def gemm_wq_cuda(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                 bias: torch.Tensor | None = None, *, scale: float = 1.0,
                 act: str | None = None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (M, K) bf16 or float32 @ dequantized qw on the card; scales
    (nb, N) float16; bias (N,) of x's dtype; epilogue ``*scale``,
    ``+bias``, activation, cast to ``out_dtype`` (bf16 or float32, default
    x.dtype)."""
    out_dtype = out_dtype or x.dtype
    check(x.is_cuda and all(t.device == x.device for t in (qw, scales))
          and (bias is None or bias.device == x.device),
          "gemm_wq: operands must be on one CUDA device")
    check(x.dtype in (torch.bfloat16, torch.float32)
          and scales.dtype == torch.float16
          and (bias is None or bias.dtype == x.dtype),
          f"gemm_wq: x bf16 or float32 ({x.dtype}), scales float16 "
          f"({scales.dtype}), bias of x's dtype")
    check(out_dtype in (torch.bfloat16, torch.float32),
          f"gemm_wq: out_dtype {out_dtype}")
    code, qb = validate(x, qw, scales, bias, act)
    M, K = x.shape
    N = qw.shape[1]
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    gx, gy = launch_geometry(M, N)
    KERNEL.launch("gemm_wq", x.data_ptr(), int(x.dtype == torch.float32),
                  qw.data_ptr(), code, scales.data_ptr(), qb,
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  M, N, K, float(scale), ACTS[act],
                  int(out_dtype == torch.float32), gx, gy, stream_ptr(x))
    return out
