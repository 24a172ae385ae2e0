"""Layer primitives of the dense decoder (``repro/models/layers.py``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops


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


def dense(x: torch.Tensor, w: torch.Tensor, *, act: str | None = None
          ) -> torch.Tensor:
    """Linear layer through the ``gemm`` kernel, the activation fused into
    its epilogue; leading dims flatten into M (``layers.py:105``)."""
    lead = x.shape[:-1]
    y = ops.gemm(x.reshape(-1, x.shape[-1]), w, act=act)
    return y.reshape(*lead, w.shape[-1])


def apply_mlp(p: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """Gated (or plain) MLP, three ``gemm`` launches when gated
    (``layers.py:134``)."""
    if gated:
        h = dense(x, p["gate"], act=act) * dense(x, p["up"])
    else:
        h = dense(x, p["up"], act=act)
    return dense(h, p["down"])
