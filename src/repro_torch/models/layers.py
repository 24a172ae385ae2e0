"""Layer primitives of the served models (``repro/models/layers.py``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.quant.tensor import QuantTensor


def apply_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computing ``x * (1 + scale)`` in float32 (``layers.py:53``)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the two halves of the head dim, not interleaved
    pairs (``layers.py:71``). x: (..., S, H, hd); positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor | QuantTensor, *,
          act: str | None = None) -> torch.Tensor:
    """Linear layer through the ``gemm`` kernel, or the ``gemm_wq`` kernel
    for a :class:`QuantTensor` weight, the activation fused into its
    epilogue; leading dims flatten into M (``layers.py:105``)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QuantTensor):
        y = ops.gemm_wq(x2, w.q, w.scales, act=act)
    else:
        y = ops.gemm(x2, w, act=act)
    return y.reshape(*lead, w.shape[-1])


def apply_mlp(p: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """Gated (or plain) MLP, three ``gemm`` (or ``gemm_wq``) launches when
    gated (``layers.py:134``)."""
    if gated:
        h = dense(x, p["gate"], act=act) * dense(x, p["up"])
    else:
        h = dense(x, p["up"], act=act)
    return dense(h, p["down"])


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None,
                  valid_len: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution (``layers.py:201``): x (B, L, C), w
    (C, K), ``state`` (B, K-1, C) the inputs before x (zeros if None).
    Returns (y (B, L, C) in x's dtype, summed in float32, and the new
    state): the last K-1 inputs, or with ``valid_len`` the K-1 inputs before
    position ``valid_len`` (only the first ``valid_len`` inputs are real)."""
    k, L = w.shape[-1], x.shape[-2]
    if state is None:
        pad = x.new_zeros(x.shape[:-2] + (k - 1, x.shape[-1]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=-2)                      # (B, L+K-1, C)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xp[..., i:i + L, :].float() * w[:, i].float()
    start = L if valid_len is None else valid_len
    return y.to(x.dtype), xp[..., start:start + k - 1, :]
