"""The Mamba-1 mixer and its diagonal recurrence
(``repro/models/recurrent.py``).

The selective scan reduces to ``h_t = a_t * h_{t-1} + b_t`` over the
flattened (d_inner, d_state) channels. Over a sequence it runs through the
``lru_scan`` kernel (``diag_scan``), one launch per chunk of at most
``ssm.chunk`` steps; a single decode step is ``a * h + b`` in plain torch, as
in the reference. The projections (``in_proj``, ``x_proj``, ``dt_proj``,
``out_proj``) are plain ``torch.matmul``, as they are plain XLA in the
reference.

A layer's parameters (``models/transformer.py``, one layer of the stacked
``blocks``): ``in_proj`` (d, 2 DI), ``conv`` (DI, d_conv), ``x_proj``
(DI, dt_rank + 2 N), ``dt_proj`` (dt_rank, DI) in the compute dtype;
``dt_bias`` (DI,), ``A_log`` (DI, N) and ``D`` (DI,) in float32. Its state
per slot: ``{"h": (B, DI * N) float32, "conv": (B, d_conv - 1, DI)}``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d


def diag_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t along axis 1 from the carry ``h0`` (B, D);
    a, b (B, L, D) float32. Returns (h (B, L, D), h_last (B, D)). The kernel
    runs from a zero state, so the carry is folded into the first step,
    h_1 = a_1 * h0 + b_1 (``recurrent.py:32-39``)."""
    b = b.clone()
    b[:, 0] += a[:, 0] * h0.to(b.dtype)
    h = ops.lru_scan(a.contiguous(), b)
    return h, h[:, -1]


def diag_scan_step(a: torch.Tensor, b: torch.Tensor, h: torch.Tensor
                   ) -> torch.Tensor:
    """One decode step of the recurrence."""
    return a * h + b


def _ssm_scan_chunked(xw: torch.Tensor, p: dict, s: SSMConfig,
                      compute_dtype: torch.dtype, h0: torch.Tensor,
                      single_step: bool, valid_len: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over post-conv features xw (B, L, DI)
    (``recurrent.py:196-254``). The (dt, B, C) projections and the
    (DI, N)-expanded recurrence inputs are made one chunk of ``s.chunk``
    steps at a time, so the O(L * DI * N) tensors never exist for the whole
    sequence. With ``valid_len`` the steps from it on are the identity
    (dt = 0: a = 1, b = 0), so h_last is the state at the last valid step.
    Returns (y (B, L, DI) float32, h_last (B, DI * N) float32)."""
    B, L, DI = xw.shape
    N = s.d_state
    dtr = p["x_proj"].shape[-1] - 2 * N
    A = -torch.exp(p["A_log"].float())                       # (DI, N)

    def chunk_ssm(xc, h, valid):
        proj = (xc @ p["x_proj"].to(compute_dtype)).float()  # (B, c, dtr+2N)
        dt, Bm, Cm = torch.split(proj, [dtr, N, N], dim=-1)
        dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"].float())
        if valid is not None:
            dt = dt * valid[None, :, None].float()
        c = xc.shape[1]
        a = torch.exp(dt[..., None] * A).reshape(B, c, DI * N)
        b = ((dt * xc.float())[..., None] * Bm[:, :, None, :]).reshape(
            B, c, DI * N)
        if single_step:
            h_new = diag_scan_step(a[:, 0], b[:, 0], h)
            hs = h_new[:, None]
        else:
            hs, h_new = diag_scan(a, b, h)
        y = torch.einsum("blds,bls->bld", hs.reshape(B, c, DI, N), Cm)
        return y + p["D"].float() * xc.float(), h_new

    step = L if single_step else s.chunk
    ys, h = [], h0
    for start in range(0, L, step):
        xc = xw[:, start:start + step]
        valid = None
        if valid_len is not None and not single_step:
            valid = torch.arange(start, start + xc.shape[1],
                                 device=xw.device) < valid_len
        y, h = chunk_ssm(xc, h, valid)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  state: dict | None = None, single_step: bool = False,
                  valid_len: int | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """The Mamba-1 block on x (B, L, d) (``recurrent.py:257-281``).
    ``state`` is None (zeros) or ``{"h": (B, DI * N), "conv": (B, K-1,
    DI)}``; ``single_step`` advances it by the one token of x;
    ``valid_len`` marks the real prefix of x for exact carries. Returns
    (out (B, L, d) in x's dtype, new state)."""
    s, cd = cfg.ssm, cfg.compute_dtype
    B = x.shape[0]
    xi, z = (x.to(cd) @ p["in_proj"].to(cd)).chunk(2, dim=-1)  # (B, L, DI)
    xw, new_conv = causal_conv1d(xi, p["conv"],
                                 None if state is None else state["conv"],
                                 valid_len=valid_len)
    xw = F.silu(xw.float()).to(cd)
    h0 = (torch.zeros(B, cfg.d_inner * s.d_state, device=x.device)
          if state is None else state["h"].float())
    y, h_last = _ssm_scan_chunked(xw, p, s, cd, h0, single_step,
                                  valid_len=valid_len)
    y = y.to(cd) * F.silu(z)
    out = (y @ p["out_proj"].to(cd)).to(x.dtype)
    return out, {"h": h_last.float(), "conv": new_conv}
