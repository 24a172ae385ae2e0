"""CUDA paged decode attention over bf16 pools (``csrc/paged_attention.cu``)
and over int8 / fp8-e4m3 pools with per-row scales
(``csrc/paged_attention_quant.cu``); both share ``csrc/paged_attention.cuh``.

The port of ``repro/kernels/paged_attention.py`` (``pl.pallas_call`` at
:154; float body ``_pa_kernel`` :96, quantized body ``_pa_kernel_quant``
:102); wrapper contract ``repro/kernels/ops.py:449``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaKernel, check, stream_ptr

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "paged_attention", replaces="src/repro/kernels/paged_attention.py:154",
    funcs={"paged_attention_bf16":
           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
            _P]})
KERNEL_QUANT = CudaKernel(
    "paged_attention_quant",
    replaces="src/repro/kernels/paged_attention.py:102",
    funcs={"paged_attention_quant":
           [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
            _I, _I, _I, _P]})

QUANT_POOLS = (torch.int8, torch.float8_e4m3fn)
HEAD_DIMS = (64, 128, 256)
G_MAX = 8
SMEM_LIMIT = 48 * 1024


def pages_to_read(length: int, page: int) -> int:
    """Pages a slot of ``length`` tokens reads: those with ``j * page <
    length`` (the page loop bound of the CUDA kernel)."""
    return -(-length // page)


def launch_geometry(B: int, K: int, G: int, D: int, page: int
                    ) -> tuple[tuple[int, int], int]:
    """Grid (slot, kv head) and the dynamic shared memory in bytes: the G
    query rows and the G x page scores, in float32."""
    return (B, K), 4 * G * (D + page)


def validate(q, k_pool, v_pool, block_tables, lengths, k_scale=None,
             v_scale=None) -> None:
    """The shapes and layout the kernels take (any device): int8 or fp8
    pools come with (N, page, K) float16 ``k_scale`` and ``v_scale``,
    float pools without. Block ids and lengths are the caller's to keep in
    range: each length in [0, P * page], each table entry a block of the
    pool."""
    check(q.dim() == 4 and k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
          f"paged_attention: q {tuple(q.shape)}, pools "
          f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    B, K, G, D = q.shape
    check(q.numel() > 0, "paged_attention: no slots")
    check(tuple(k_pool.shape[2:]) == (K, D),
          "paged_attention: pool heads/dim differ from q")
    check(block_tables.dim() == 2 and block_tables.shape[0] == B
          and tuple(lengths.shape) == (B,),
          "paged_attention: tables (B, P), lengths (B,)")
    check(block_tables.dtype == lengths.dtype == torch.int32,
          "paged_attention: int32 block tables and lengths")
    check(all(t.is_contiguous() for t in
              (q, k_pool, v_pool, block_tables, lengths)),
          "paged_attention: operands must be contiguous")
    quant = k_pool.dtype in QUANT_POOLS or v_pool.dtype in QUANT_POOLS
    check(quant == (k_scale is not None) == (v_scale is not None),
          f"paged_attention: {k_pool.dtype} pools need k_scale and v_scale "
          "exactly when they hold int8 or fp8 codes")
    if quant:
        check(k_pool.dtype == v_pool.dtype,
              "paged_attention: k and v pools of one dtype")
        for t in (k_scale, v_scale):
            check(tuple(t.shape) == tuple(k_pool.shape[:3])
                  and t.dtype == torch.float16 and t.is_contiguous(),
                  f"paged_attention: scales must be contiguous float16 "
                  f"{tuple(k_pool.shape[:3])}, got {tuple(t.shape)} "
                  f"{t.dtype}")


def _geometry(q, k_pool, scale):
    B, K, G, D = q.shape
    page = k_pool.shape[1]
    check(D in HEAD_DIMS and 1 <= G <= G_MAX,
          f"paged_attention: D {D} not in {HEAD_DIMS} or G {G} > {G_MAX}")
    (grid_x, grid_y), smem = launch_geometry(B, K, G, D, page)
    check(smem <= SMEM_LIMIT, f"paged_attention: page {page} needs {smem} "
          "bytes of shared memory")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    return K, G, D, page, float(scale), grid_x, grid_y, smem


def paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths,
                         k_scale=None, v_scale=None, *,
                         scale: float | None = None,
                         cap: float = 0.0) -> torch.Tensor:
    """q (B, K, G, D) bf16; pools (N, page, K, D) bf16, or int8 / fp8-e4m3
    with (N, page, K) float16 ``k_scale`` and ``v_scale``; block_tables
    (B, P) int32; lengths (B,) int32. Returns (B, K, G, D) bf16."""
    scales = () if k_scale is None else (k_scale, v_scale)
    check(q.is_cuda and all(t.device == q.device for t in
                            (k_pool, v_pool, block_tables, lengths, *scales)),
          "paged_attention: all operands must be on one CUDA device")
    check(q.dtype == torch.bfloat16 and k_pool.dtype == v_pool.dtype
          and k_pool.dtype in (torch.bfloat16, *QUANT_POOLS),
          f"paged_attention: bf16 q, bf16 / int8 / fp8 pools; got {q.dtype} "
          f"and {k_pool.dtype}")
    validate(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale)
    K, G, D, page, scale, grid_x, grid_y, smem = _geometry(q, k_pool, scale)
    out = torch.empty_like(q)
    common = (K, G, D, page, block_tables.shape[1], scale, float(cap),
              grid_x, grid_y, smem, stream_ptr(q))
    if scales:
        KERNEL_QUANT.launch(
            "paged_attention_quant", q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            int(k_pool.dtype == torch.float8_e4m3fn), *common)
    else:
        KERNEL.launch("paged_attention_bf16", q.data_ptr(), k_pool.data_ptr(),
                      v_pool.data_ptr(), block_tables.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(), *common)
    return out
