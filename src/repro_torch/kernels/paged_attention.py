"""CUDA paged decode attention (``csrc/paged_attention.cu``).

The port of ``repro/kernels/paged_attention.py`` (``pl.pallas_call`` at
:154, float pools); wrapper contract ``repro/kernels/ops.py:449``.
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


def validate(q, k_pool, v_pool, block_tables, lengths) -> None:
    """The shapes and layout the kernel takes (any device). Block ids and
    lengths are the caller's to keep in range: each length in
    [0, P * page], each table entry a block of the pool."""
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


def paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths, *,
                         scale: float | None = None,
                         cap: float = 0.0) -> torch.Tensor:
    """q (B, K, G, D) bf16; pools (N, page, K, D) bf16; block_tables (B, P)
    int32; lengths (B,) int32. Returns (B, K, G, D)."""
    check(q.is_cuda and all(t.device == q.device for t in
                            (k_pool, v_pool, block_tables, lengths)),
          "paged_attention: all operands must be on one CUDA device")
    check(q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16,
          "paged_attention: bf16 q and pools only")
    validate(q, k_pool, v_pool, block_tables, lengths)
    B, K, G, D = q.shape
    page = k_pool.shape[1]
    check(D in HEAD_DIMS and 1 <= G <= G_MAX,
          f"paged_attention: D {D} not in {HEAD_DIMS} or G {G} > {G_MAX}")
    (grid_x, grid_y), smem = launch_geometry(B, K, G, D, page)
    check(smem <= SMEM_LIMIT, f"paged_attention: page {page} needs {smem} "
          "bytes of shared memory")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    KERNEL.launch("paged_attention_bf16", q.data_ptr(), k_pool.data_ptr(),
                  v_pool.data_ptr(), block_tables.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), K, G, D, page,
                  block_tables.shape[1], float(scale), float(cap), grid_x,
                  grid_y, smem, stream_ptr(q))
    return out
