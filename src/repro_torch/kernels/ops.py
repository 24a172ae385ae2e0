"""The kernels of the serving path, routed by the device of their tensors.

On CUDA tensors each op launches its hand-written kernel (or raises: there
is no fallback on the card); on CPU tensors it runs the plain PyTorch
version in :mod:`repro_torch.kernels.ref`, after the same shape and layout
checks the kernel's wrapper makes, so CPU runs hold callers to what the
kernel takes. Counterparts of
``repro/kernels/ops.py`` ``gemm`` (:98), ``flash_attention`` (:359) and
``paged_attention`` (:449).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

#: the CUDA kernels of this path, each with its ``launches`` count
KERNELS = (_gemm.KERNEL, _pa.KERNEL, _fa.KERNEL)


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


def paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                    scale: float | None = None,
                    cap: float = 0.0) -> torch.Tensor:
    """q (B, K, G, D) one token per slot; pools (N, page, K, D);
    block_tables (B, P) int32; lengths (B,) int32."""
    if q.is_cuda:
        return _pa.paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                        lengths, scale=scale, cap=cap)
    _pa.validate(q, k_pool, v_pool, block_tables, lengths)
    return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                                   scale=scale, cap=cap)
