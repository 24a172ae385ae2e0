"""The kernels of the serving path, routed by the device of their tensors.

On CUDA tensors each op launches its hand-written kernel (or raises: there
is no fallback on the card); on CPU tensors it runs the plain PyTorch
version in :mod:`repro_torch.kernels.ref`, after the same shape and layout
checks the kernel's wrapper makes, so CPU runs hold callers to what the
kernel takes. Counterparts of
``repro/kernels/ops.py`` ``gemm`` (:98), ``gemm_wq`` (:181),
``flash_attention`` (:359), ``paged_attention`` (:449), ``lru_scan``
(:477) and ``packed_gather_rows`` (:563).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import gemm_wq as _wq
from repro_torch.kernels import lru_scan as _lru
from repro_torch.kernels import packed_gather as _pg
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

#: the CUDA kernels of the serving paths, each with its ``launches`` count
KERNELS = (_gemm.KERNEL, _pa.KERNEL, _fa.KERNEL, _wq.KERNEL, _pa.KERNEL_QUANT,
           _lru.KERNEL, _pg.KERNEL)


def gemm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
         *, scale: float = 1.0, act: str | None = None,
         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) with the fused ``*scale``, ``+bias``, activation
    and cast to ``out_dtype`` (default x.dtype)."""
    if x.is_cuda:
        return _gemm.gemm_cuda(x, w, bias, scale=scale, act=act,
                               out_dtype=out_dtype)
    _gemm.validate(x, w, bias, act)
    return ref.gemm_ref(x, w, bias=bias, scale=scale, act=act,
                        out_dtype=out_dtype)


def gemm_wq(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
            bias: torch.Tensor | None = None, *, scale: float = 1.0,
            act: str | None = None,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (M, K) @ the weight held as codes qw (K, N) int8 / fp8-e4m3, or
    (K/2, N) int8 bytes of packed int4, with (nb, N) float16 block scales
    (nb | K); the same epilogue as :func:`gemm`."""
    if x.is_cuda:
        return _wq.gemm_wq_cuda(x, qw, scales, bias, scale=scale, act=act,
                                out_dtype=out_dtype)
    _wq.validate(x, qw, scales, bias, act)
    return ref.gemm_wq_ref(x, qw, scales, bias=bias, scale=scale, act=act,
                           out_dtype=out_dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0, scale: float | None = None,
                    kv_len: int = 0) -> torch.Tensor:
    """q (BH, Sq, D); k, v (BK, Skv, D), BH % BK == 0 (GQA groups)."""
    if q.is_cuda:
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        cap=cap, scale=scale, kv_len=kv_len)
    _fa.validate(q, k, v, window=window, kv_len=kv_len)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap, scale=scale, kv_len=kv_len)


def paged_attention(q, k_pool, v_pool, block_tables, lengths, k_scale=None,
                    v_scale=None, *, scale: float | None = None,
                    cap: float = 0.0) -> torch.Tensor:
    """q (B, K, G, D) one token per slot; pools (N, page, K, D);
    block_tables (B, P) int32; lengths (B,) int32. int8 or fp8 pools carry
    (N, page, K) float16 ``k_scale``/``v_scale`` and raise without them:
    attention over raw codes would be silently wrong."""
    if q.is_cuda:
        return _pa.paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                        lengths, k_scale, v_scale,
                                        scale=scale, cap=cap)
    _pa.validate(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale)
    return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                                   k_scale, v_scale, scale=scale, cap=cap)


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from a zero state; a, b
    (B, L, D) float32, contiguous."""
    if a.is_cuda:
        return _lru.lru_scan_cuda(a, b)
    _lru.validate(a, b)
    return ref.lru_scan_ref(a, b)


def packed_gather_rows(table: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """out[i] = table[idx[i]]: table (N, D) bf16 / fp16 / fp32, idx (M,)
    int32 or int64 in any order, clamped as jnp indexing clamps."""
    if table.is_cuda:
        return _pg.packed_gather_rows_cuda(table, idx)
    _pg.validate(table, idx)
    return ref.gather_rows_ref(table, idx)
