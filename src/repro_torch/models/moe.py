"""Mixture-of-experts MLP with capacity-drop routing
(``repro/models/moe.py``, the ``dispatch="sort"`` path).

Each token picks ``top_k`` of ``n_experts`` experts by a float32 softmax
router. Tokens are grouped as the reference groups them (``moe.py:359``):
one group per batch row when S > 1, and all B rows in one group at decode
(S == 1). Within a group an expert takes at most
``C = capacity(m, T)`` of its (token, slot) assignments, in token order:
the assignments are sorted by expert with a stable sort, so the earlier
tokens keep the expert and a later one loses it (its contribution is
zero). The kept token rows are packed into dense per-expert blocks
``(G, E, C, d)`` through the ``packed_gather_rows`` kernel, every expert
runs its gated FFN on its block, and the outputs are weighted by the gate
and summed back per token. The shared expert (an MLP through ``gemm``,
gated by a sigmoid of ``x @ shared_gate``) is added to every token.

Parameters are one layer's slice of the stacked ``blocks``
(``models/transformer.py``): ``router`` (d, E) float32,
``experts_gate`` / ``experts_up`` (E, d, f), ``experts_down`` (E, f, d),
the shared expert's ``gate`` / ``up`` / ``down`` and ``shared_gate``
(d, 1). The load-balancing loss of the reference's router is training's
and is not computed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_mlp


def capacity(m: MoEConfig, tokens_per_group: int) -> int:
    """Assignments an expert keeps per group (``moe.py:56``)."""
    c = int(math.ceil(tokens_per_group * m.top_k / m.n_experts
                      * m.capacity_factor))
    return max(c, 1)


def _route(p: dict, m: MoEConfig, x_f32: torch.Tensor):
    """x_f32 (G, T, d) -> (gate weights (G, T, k) float32, expert indices
    (G, T, k)) (``moe.py:61``, less the aux loss)."""
    probs = torch.softmax(x_f32 @ p["router"].float(), dim=-1)
    gate, idx = torch.topk(probs, m.top_k, dim=-1)
    if m.renorm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate, idx


def _dispatch_sort(x: torch.Tensor, idx: torch.Tensor, C: int, E: int):
    """Pack each group's kept token rows into per-expert blocks
    (``moe.py:77``). x (G, T, d); idx (G, T, k). Returns xe (G, E, C, d)
    and the combine's (dest, order).

    The groups are sorted in one stable argsort of ``g * E + e`` over the
    flat (group, token, slot) order, which sorts each group by expert and
    keeps its token order, as the reference's per-group sort does;
    ``dest`` is each sorted assignment's row of the packed blocks, or the
    overflow row ``G * E * C`` when it is past its expert's capacity."""
    G, T, k = idx.shape
    d = x.shape[-1]
    dev = x.device
    groups = torch.arange(G, device=dev)[:, None, None]
    flat_e = (idx + E * groups).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = torch.div(order, k, rounding_mode="floor")
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    seg_pos = torch.arange(flat_e.numel(), device=dev) - first
    dest = torch.where(seg_pos < C, sorted_e * C + seg_pos,
                       torch.full_like(seg_pos, G * E * C))
    # the token-row stream, an indexed gather in expert order
    gathered = ops.packed_gather_rows(x.reshape(G * T, d), sorted_tok)
    xe_flat = x.new_zeros(G * E * C + 1, d)
    # dropped rows all land on the overflow row, which is cut off
    xe_flat.index_copy_(0, dest, gathered)
    return xe_flat[:-1].view(G, E, C, d), (dest, order)


def _combine_sort(ye: torch.Tensor, meta, gate: torch.Tensor) -> torch.Tensor:
    """Weight each kept expert output by its gate and sum a token's k
    outputs (``moe.py:109``). ye (G, E, C, d); gate (G, T, k). Returns
    (G, T, d) in ye's dtype.

    The reference scatter-adds the sorted rows onto zeros; here the rows
    go back to (token, slot) order through the sort's permutation and the
    k slots are summed, in a fixed order on every device."""
    dest, order = meta
    G, E, C, d = ye.shape
    _, T, k = gate.shape
    ye_flat = torch.cat([ye.reshape(G * E * C, d), ye.new_zeros(1, d)])
    y_sorted = ye_flat[dest] * gate.reshape(-1)[order].to(ye.dtype)[:, None]
    y = torch.empty_like(y_sorted)
    y[order] = y_sorted
    return y.view(G, T, k, d).sum(2)


def _expert_ffn(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """The dense expert path (``moe.py:185``): every expert's gated FFN on
    its packed block, as batched products over the experts. xe
    (G, E, C, d) -> (G, E, C, d). The reference's einsums are plain XLA,
    so these are plain PyTorch; its dense path applies silu whatever
    ``cfg.act`` says, and so does this one."""
    G, E, C, d = xe.shape
    xs = xe.transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(xs, p["experts_gate"])) * torch.bmm(
        xs, p["experts_up"])
    ye = torch.bmm(h, p["experts_down"])
    return ye.view(E, G, C, d).transpose(0, 1)


def _add_shared(p: dict, cfg: ModelConfig, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """The shared expert through ``gemm``, gated by a sigmoid of
    ``x @ shared_gate`` (``moe.py:387``)."""
    m = cfg.moe
    if not m.shared_hidden:
        return y
    ys = apply_mlp(p, x, cfg.act, True)
    if m.shared_gate:
        ys = ys * torch.sigmoid(x @ p["shared_gate"])
    return y + ys


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                capacity_tokens: int | None = None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) (``moe.py:349``, ``dispatch="sort"``).

    ``capacity_tokens``, when given, is the T that sets the capacity in
    place of the group's own length: a ragged last prefill chunk routes
    its valid rows with the capacity of the padded chunk the reference
    routes (``repro/serve/engine.py:1351``). Its pad rows sort after the
    valid rows within each expert and so never take a valid row's place;
    leaving them out gives the valid rows the reference's result."""
    m = cfg.moe
    B, S, d = x.shape
    G = B if S > 1 else 1          # group along batch; decode: one group
    T = B * S // G
    if capacity_tokens is not None and capacity_tokens < T:
        raise ValueError(f"capacity_tokens {capacity_tokens} < group "
                         f"length {T}")
    xg = x.reshape(G, T, d)
    gate, idx = _route(p, m, xg.float())
    C = capacity(m, capacity_tokens or T)
    xe, meta = _dispatch_sort(xg, idx, C, m.n_experts)
    y = _combine_sort(_expert_ffn(p, xe), meta, gate)
    return _add_shared(p, cfg, x, y.reshape(B, S, d))
