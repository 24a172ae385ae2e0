"""Post-load weight quantization keyed off ``ModelConfig``
(``repro/quant/params.py``), over the port's parameter dict
(``models/transformer.py``).

What is quantized, as in the reference: every stacked projection kernel
(``q_proj``, ``k_proj``, ``v_proj``, ``o_proj``, ``gate``, ``up``,
``down``) and an untied ``lm_head`` along its contraction axis (-2) with
``quant_block`` scales; the embedding table **per row** (axis -1, one scale
per token id), so the lookup dequantizes only the rows it gathers. Norms
stay dense.
"""
from __future__ import annotations

from repro_torch.quant.tensor import (QuantTensor, canonical_dtype,
                                      quantize_tensor)

#: the stacked ``blocks`` entries that are matmul kernels
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate", "up", "down")


def quantize_params(params: dict, cfg) -> dict:
    """Wrap the matmul weights of ``params`` in :class:`QuantTensor` objects,
    as ``cfg.weight_dtype`` and ``cfg.quant_block`` say.

    Returns ``params`` itself when ``cfg.weight_dtype`` is unset; leaves
    that are already quantized pass through.
    """
    if not cfg.weight_dtype:
        return params
    dtype, block = canonical_dtype(cfg.weight_dtype), cfg.quant_block

    def q(t, axis, blk):
        if isinstance(t, QuantTensor):
            return t
        return quantize_tensor(t, dtype, block=blk, axis=axis)

    blocks = {name: q(t, -2, block) if name in PROJECTIONS else t
              for name, t in params["blocks"].items()}
    out = {**params, "blocks": blocks, "embed": q(params["embed"], -1, 0)}
    if "lm_head" in params:
        out["lm_head"] = q(params["lm_head"], -2, block)
    return out


def _leaves(params: dict):
    for name, t in params.items():
        if isinstance(t, dict):
            yield from _leaves(t)
        else:
            yield t


def is_quantized(params: dict) -> bool:
    return any(isinstance(t, QuantTensor) for t in _leaves(params))


def param_bytes(params: dict) -> int:
    """Storage bytes of a parameter dict (a QuantTensor counts its codes
    and scales)."""
    return sum(t.nbytes if isinstance(t, QuantTensor)
               else t.numel() * t.element_size() for t in _leaves(params))


__all__ = ["PROJECTIONS", "is_quantized", "param_bytes", "quantize_params"]
