"""Plain PyTorch versions of the kernels (``repro/kernels/ref.py`` :8, :23,
:62, :89, :124, :140).

They are what ``kernels/ops.py`` runs on CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel against on the card. Every one
computes in float32 and returns the dtype the kernel returns; the row
gather computes nothing and copies rows as they are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.quant.tensor import as_bytes, unpack_int4

NEG_INF = -1e30


def _act(x: torch.Tensor, act: str | None) -> torch.Tensor:
    if act is None:
        return x
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"act={act!r}; expected None, 'silu' or 'gelu'")


def gemm_ref(x, w, *, bias=None, scale: float = 1.0, act: str | None = None,
             out_dtype: torch.dtype | None = None):
    """(M, K) @ (K, N) in float32, then ``*scale``, ``+bias``, activation
    (silu, or gelu's tanh form), cast to ``out_dtype`` (default x.dtype)."""
    out = x.float() @ w.float()
    if scale != 1.0:
        out = out * scale
    if bias is not None:
        out = out + bias.float()
    return _act(out, act).to(out_dtype or x.dtype)


def gemm_wq_ref(x, qw, scales, *, bias=None, scale: float = 1.0,
                act: str | None = None, out_dtype: torch.dtype | None = None):
    """Weight-quantized x (M, K) @ qw: qw (K, N) int8 or fp8-e4m3 codes, or
    (K/2, N) int8 bytes of packed int4 (told apart by the half-K relation),
    with (nb, N) scales, nb | K. The weight is unpacked and dequantized in
    float32, then ``gemm_ref`` applies the epilogue."""
    if qw.shape[0] * 2 == x.shape[-1] and qw.dtype == torch.int8:
        qw = unpack_int4(qw, axis=0)
    K, N = qw.shape
    nb = scales.shape[0]
    w = (qw.float().reshape(nb, K // nb, N)
         * scales.float()[:, None, :]).reshape(K, N)
    return gemm_ref(x, w, bias=bias, scale=scale, act=act,
                    out_dtype=out_dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        cap: float = 0.0, scale: float | None = None,
                        kv_len: int = 0):
    """q: (BH, Sq, D); k, v: (BK, Skv, D), BH % BK == 0; query head ``b``
    reads KV head ``b // (BH // BK)``. ``kv_len`` (0 = Skv) masks padded
    KV rows, as the Pallas kernel's argument of that name does."""
    BH, Sq, D = q.shape
    BK, Skv, _ = k.shape
    if BH % BK:
        raise ValueError(f"BH {BH} is not a multiple of BK {BK}")
    G = BH // BK
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.einsum("bgqd,bkd->bgqk", q.reshape(BK, G, Sq, D).float(),
                     k.float()) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = kpos < (kv_len or Skv)
    if causal:
        mask = mask & (qpos >= kpos)
    if window:
        mask = mask & (qpos - kpos < window)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    return out.reshape(BH, Sq, D).to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                        k_scale=None, v_scale=None, *,
                        scale: float | None = None, cap: float = 0.0):
    """q: (B, K, G, D) one token per slot; pools (N, page, K, D);
    block_tables (B, P) int32; lengths (B,) int32. Row ``p`` of slot ``b``
    is ``pool[block_tables[b, p // page], p % page]``. ``k_scale`` and
    ``v_scale`` ((N, page, K) float16) mark int8 or fp8 pools, whose
    gathered rows are dequantized in float32 before scoring.

    A slot of length 0 reads no page and returns zeros, as the Pallas
    kernel and the CUDA kernel do (``repro``'s gather oracle averages the
    null block's rows there instead; the engine never reads that output).
    """
    B, K, G, D = q.shape
    page = k_pool.shape[1]
    P = block_tables.shape[1]
    tables = block_tables.long()

    def rows(pool, row_scale):
        r = as_bytes(pool)[tables].view(pool.dtype).reshape(
            B, P * page, K, D).float()
        if row_scale is not None:
            r = r * row_scale[tables].reshape(B, P * page, K, 1).float()
        return r
    kk, vv = rows(k_pool, k_scale), rows(v_pool, v_scale)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), kk) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    valid = (torch.arange(P * page, device=q.device)[None, :]
             < lengths.long()[:, None])
    p = torch.softmax(s.masked_fill(~valid[:, None, None, :], NEG_INF), -1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vv)
    out = out * (lengths > 0).reshape(B, 1, 1, 1)
    return out.to(q.dtype)


def lru_scan_ref(a, b):
    """Diagonal recurrence h_t = a_t * h_{t-1} + b_t along axis 1 from a
    zero state, in float32, one step after another. a, b: (B, L, D)."""
    a, b = a.float(), b.float()
    h = torch.empty_like(a)
    carry = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        carry = a[:, t] * carry + b[:, t]
        h[:, t] = carry
    return h


def gather_rows_ref(table, idx):
    """Indexed row stream: out[i] = table[idx[i]]. A negative index counts
    from the end and any index is then clamped to [0, N - 1], as jnp
    indexing does (torch indexing would raise instead)."""
    n = table.shape[0]
    idx = idx.long()
    return table[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]
