"""The model spine (``repro/models/transformer.py``): a dense decoder, the
same with a mixture-of-experts MLP in every layer (``cfg.is_moe``), or a
stack of Mamba-1 blocks (``cfg.is_ssm``).

Parameters are a plain dict of tensors in the compute dtype. Per-layer
tensors are stacked on a leading ``blocks`` axis, as the reference stacks
its scanned pattern (``transformer.py:76-114``):

    {"embed": (V, d), "final_norm": (d,), ["lm_head": (d, V)],
     "blocks": {"pre_norm", "q_proj", "k_proj", "v_proj", "o_proj",
                ["q_norm", "k_norm"], "mlp_norm", ["gate"], "up", "down"}}

where a MoE layer has, in place of the dense MLP, the float32
``router`` (d, E), the routed experts ``experts_gate`` / ``experts_up``
(E, d, f) and ``experts_down`` (E, f, d), the shared expert as ``gate`` /
``up`` / ``down`` and its sigmoid gate ``shared_gate`` (d, 1)
(``models/moe.py``); or, for Mamba layers, which have no MLP and no MLP
norm,

     "blocks": {"pre_norm", "in_proj", "conv", "x_proj", "dt_proj",
                "dt_bias", "A_log", "D", "out_proj"}

(``models/recurrent.py``; ``dt_bias``, ``A_log`` and ``D`` stay float32),
with projection kernels stored (d_in, d_out) and norms computing
``x * (1 + scale)``. After ``quant.quantize_params`` the projection kernels
and the embedding table are :class:`~repro_torch.quant.QuantTensor` objects:
stacked ones slice per layer like tensors, the embedding lookup
dequantizes only the rows it gathers, and the tied LM head dequantizes the
table per call, a slab of rows at a time, keeping no dense copy.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm
from repro_torch.models.moe import moe_forward
from repro_torch.models.recurrent import mamba_forward
from repro_torch.quant.tensor import QuantTensor

#: rows of a quantized tied embedding table dequantized at a time by
#: ``logits_fn`` (a 64 MiB float32 slab at d_model 1024)
HEAD_ROWS = 16384


def init(cfg: ModelConfig, *, seed: int = 0, device: str = "cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``:
    the reference's initializers (normal / sqrt(fan_in) kernels and
    embedding, zero norm scales; Mamba's S4D-real ``A_log``, ``D`` = 1 and
    a ``dt_proj`` bias of -4.6, ``recurrent.py:174-193``; a MoE layer's
    leaves with ``moe.py:32-53``'s shapes, the router kept in float32),
    drawn in float32 and cast once to the compute dtype. They are not
    ``jax.random``'s numbers."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim
    H, K, F, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size

    def normal(shape, fan_in, dtype=cfg.compute_dtype):
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=cfg.compute_dtype)

    if cfg.is_ssm:
        blocks = _mamba_init(cfg, normal, dev)
        blocks["pre_norm"] = zeros(L, d)
        return {"embed": normal((V, d), d), "final_norm": zeros(d),
                "blocks": blocks}
    blocks = {"pre_norm": zeros(L, d), "q_proj": normal((L, d, H * hd), d),
              "k_proj": normal((L, d, K * hd), d),
              "v_proj": normal((L, d, K * hd), d),
              "o_proj": normal((L, H * hd, d), H * hd),
              "mlp_norm": zeros(L, d)}
    if cfg.qk_norm:
        blocks["q_norm"] = zeros(L, hd)
        blocks["k_norm"] = zeros(L, hd)
    if cfg.is_moe:
        blocks.update(_moe_init(cfg, normal, dev))
    else:
        blocks.update(up=normal((L, d, F), d), down=normal((L, F, d), F))
        if cfg.gated_mlp:
            blocks["gate"] = normal((L, d, F), d)
    params = {"embed": normal((V, d), d), "final_norm": zeros(d),
              "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, V), d)
    return params


def _stacked(cfg: ModelConfig, normal, dev: torch.device, shape: tuple,
             fan_in: int) -> torch.Tensor:
    """A (layers,) + shape kernel whose layers are drawn in float32 and
    cast one at a time, so the float32 temporary is one layer's (a
    stacked ``in_proj`` of falcon-mamba-7b would be 17 GB in float32, an
    expert slab of qwen2-moe-a2.7b 16.6 GB)."""
    out = torch.empty((cfg.n_layers,) + shape, dtype=cfg.compute_dtype,
                      device=dev)
    for i in range(cfg.n_layers):
        out[i] = normal(shape, fan_in)
    return out


def _mamba_init(cfg: ModelConfig, normal, dev: torch.device) -> dict:
    """The stacked Mamba leaves."""
    L, d, s = cfg.n_layers, cfg.d_model, cfg.ssm
    DI, N, R = cfg.d_inner, s.d_state, cfg.dt_rank

    stacked = functools.partial(_stacked, cfg, normal, dev)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
    return {"in_proj": stacked((d, 2 * DI), d),
            "conv": stacked((DI, s.d_conv), s.d_conv),
            "x_proj": stacked((DI, R + 2 * N), DI),
            "dt_proj": stacked((R, DI), R),
            "dt_bias": torch.full((L, DI), -4.6, device=dev),
            "A_log": torch.log(A).expand(L, DI, N).contiguous(),
            "D": torch.ones(L, DI, device=dev),
            "out_proj": stacked((DI, d), DI)}


def _moe_init(cfg: ModelConfig, normal, dev: torch.device) -> dict:
    """The stacked MoE leaves; the router stays float32."""
    L, d, m = cfg.n_layers, cfg.d_model, cfg.moe
    E, f, fs = m.n_experts, m.d_expert, m.shared_hidden

    stacked = functools.partial(_stacked, cfg, normal, dev)
    leaves = {"router": normal((L, d, E), d, torch.float32),
              "experts_gate": stacked((E, d, f), d),
              "experts_up": stacked((E, d, f), d),
              "experts_down": stacked((E, f, d), f)}
    if fs:
        leaves.update(gate=stacked((d, fs), d), up=stacked((d, fs), d),
                      down=stacked((fs, d), fs))
        if m.shared_gate:
            leaves["shared_gate"] = normal((L, d, 1), d)
    return leaves


def _layers(params: dict):
    """Per-layer views of the stacked ``blocks`` tensors."""
    blocks = params["blocks"]
    n = next(iter(blocks.values())).shape[0]
    for i in range(n):
        yield i, {name: t[i] for name, t in blocks.items()}


def _block(lp: dict, cfg: ModelConfig, x: torch.Tensor, mix, *,
           capacity_tokens: int | None = None) -> torch.Tensor:
    """Pre-norm residual block: the mixer (attention or Mamba), then the
    MLP, dense or mixture-of-experts (``capacity_tokens`` goes to
    :func:`~repro_torch.models.moe.moe_forward`); a Mamba layer
    (``mlp == "none"``) has no MLP (``transformer.py:141-258``)."""
    x = x + mix(apply_norm(lp["pre_norm"], x, cfg.norm_eps))
    if cfg.is_ssm:
        return x
    h = apply_norm(lp["mlp_norm"], x, cfg.norm_eps)
    if cfg.is_moe:
        return x + moe_forward(lp, cfg, h, capacity_tokens=capacity_tokens)
    return x + apply_mlp(lp, h, cfg.act, cfg.gated_mlp)


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """(B, S) int ids -> (B, S, d) in the compute dtype (``:382``); a
    quantized table dequantizes only the looked-up rows."""
    table = params["embed"]
    if isinstance(table, QuantTensor):
        return table.take_rows(tokens, dtype=cfg.compute_dtype)
    return table[tokens]


def logits_fn(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head (the tied embedding unless ``lm_head``), as
    float32 logits (``:405``)."""
    h = apply_norm(params["final_norm"], x, cfg.norm_eps)
    if not cfg.tie_embeddings:
        head = params["lm_head"]
        if isinstance(head, QuantTensor):
            head = head.dequantize(h.dtype)
        return (h @ head).float()
    table = params["embed"]
    if not isinstance(table, QuantTensor):
        return (h @ table.T).float()
    return torch.cat([
        (h @ table[r:r + HEAD_ROWS].dequantize(h.dtype).T).float()
        for r in range(0, table.shape[0], HEAD_ROWS)], dim=-1)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Whole-sequence causal pass, (B, S) ids -> hidden (B, S, d); every
    layer's attention reads through ``flash_attention``, every Mamba
    layer's recurrence runs through ``lru_scan`` from a zero state, one
    launch per ``ssm.chunk`` tokens (``:448``)."""
    x = embed_tokens(params, cfg, tokens)
    for _, lp in _layers(params):
        if cfg.is_ssm:
            mix = lambda h, lp=lp: mamba_forward(lp, cfg, h)[0]
        else:
            mix = lambda h, lp=lp: attn.attention_forward(lp, cfg, h)
        x = _block(lp, cfg, x, mix)
    return x


def _mamba_state_step(lp: dict, cfg: ModelConfig, cache: dict, i: int,
                      rows, h: torch.Tensor, *, fresh: bool = False,
                      single_step: bool = False) -> torch.Tensor:
    """Layer ``i``'s Mamba mixer on h, reading the state of slots ``rows``
    (a tensor of slot indices, or a slice), or zeros if ``fresh``, and
    writing the new state back in place."""
    state = {name: cache[name][i, rows] for name in ("h", "conv")}
    if fresh:
        state = {name: torch.zeros_like(t) for name, t in state.items()}
    out, new = mamba_forward(lp, cfg, h, state=state,
                             single_step=single_step)
    for name in ("h", "conv"):
        cache[name][i, rows] = new[name].to(cache[name].dtype)
    return out


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor,
                block_tables: torch.Tensor,
                slots: torch.Tensor | None = None) -> torch.Tensor:
    """One decode step for B slots: tokens (B, 1) at positions ``pos``
    (B,), slots' block-table rows (B, P) int32. Writes the pools in place;
    returns logits (B, 1, V) (``:479``). A Mamba model needs ``slots``
    (B,), the slot index of each row, and reads and writes those state rows
    of its cache only, so a slot that is not decoding keeps its state (the
    reference masks the others, ``:133-138``)."""
    if cfg.is_ssm and slots is None:
        raise ValueError("a mamba decode step needs the slot of each row")
    x = embed_tokens(params, cfg, tokens)
    for i, lp in _layers(params):
        if cfg.is_ssm:
            mix = lambda h, lp=lp, i=i: _mamba_state_step(
                lp, cfg, cache, i, slots, h, single_step=True)
        else:
            pools = {name: t[i] for name, t in cache.items()}
            mix = lambda h, lp=lp, pools=pools: attn.attention_decode(
                lp, cfg, h, pools, pos, block_tables)
        x = _block(lp, cfg, x, mix)
    return logits_fn(params, cfg, x)


def extend_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int, slot: int,
                block_tables: torch.Tensor,
                padded_len: int | None = None) -> torch.Tensor:
    """Chunked prefill of slot ``slot``: tokens (1, T) at positions
    ``pos .. pos+T-1``. Writes the pools in place; returns the logits
    (1, 1, V) of the chunk's last token (``:512``). A Mamba layer carries
    the slot's state from the previous chunk, and starts it from zero on
    the first chunk (``pos == 0``), so a reused slot keeps nothing of its
    last request (``transformer.py:198-206``). ``padded_len`` (default T)
    is the length the reference pads a ragged chunk to behind ``n_valid``
    (the engine's ``prefill_chunk``): a MoE layer takes its expert
    capacity from it, as the reference's padded chunk does."""
    if padded_len is not None and padded_len < tokens.shape[1]:
        raise ValueError(f"padded_len {padded_len} < chunk length "
                         f"{tokens.shape[1]}")
    x = embed_tokens(params, cfg, tokens)
    table = block_tables[slot]
    for i, lp in _layers(params):
        if cfg.is_ssm:
            mix = lambda h, lp=lp, i=i: _mamba_state_step(
                lp, cfg, cache, i, slice(slot, slot + 1), h, fresh=pos == 0)
        else:
            pools = {name: t[i] for name, t in cache.items()}
            mix = lambda h, lp=lp, pools=pools: attn.attention_extend(
                lp, cfg, h, pools, pos, table)
        x = _block(lp, cfg, x, mix, capacity_tokens=padded_len)
    return logits_fn(params, cfg, x[:, -1:])
