"""Plain PyTorch versions of the kernels (``repro/kernels/ref.py`` :8, :62, :89).

They are what ``kernels/ops.py`` runs on CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel against on the card. Every one
computes in float32 and returns the dtype the kernel returns.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                        scale: float | None = None, cap: float = 0.0):
    """q: (B, K, G, D) one token per slot; pools (N, page, K, D);
    block_tables (B, P) int32; lengths (B,) int32. Row ``p`` of slot ``b``
    is ``pool[block_tables[b, p // page], p % page]``.

    A slot of length 0 reads no page and returns zeros, as the Pallas
    kernel and the CUDA kernel do (``repro``'s gather oracle averages the
    null block's rows there instead; the engine never reads that output).
    """
    B, K, G, D = q.shape
    page = k_pool.shape[1]
    P = block_tables.shape[1]
    tables = block_tables.long()
    kk = k_pool[tables].reshape(B, P * page, K, D).float()
    vv = v_pool[tables].reshape(B, P * page, K, D).float()
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
