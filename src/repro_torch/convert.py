"""Load the reference's parameters into the port.

:func:`convert_params` takes the JAX package's parameter pytree as numpy
arrays (nested dicts and lists, as ``repro.models.init`` builds it and
``jax.tree.map(np.asarray, params)`` exports it) and returns the port's
parameter dict (``models/transformer.py``). :func:`load_checkpoint` reads a
``repro.ckpt`` step directory (``manifest.json`` plus one ``.npy`` per leaf)
into such a pytree without importing ``repro``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve


def convert_params(tree: dict, cfg: ModelConfig, *, device: str = "cuda"
                   ) -> dict:
    """Reference pytree -> port params, cast once to the compute dtype.

    The reference stacks its repeated layer pattern under
    ``tree["blocks"]`` (a list with one entry per pattern position, each
    leaf carrying a leading layer axis); the port serves single-spec
    patterns with no unrolled prefix or suffix layers.
    """
    dev = resolve(device)
    if "prefix" in tree or "suffix" in tree or len(tree["blocks"]) != 1:
        raise NotImplementedError(
            "the port converts one stacked full-attention dense pattern "
            "with no prefix/suffix layers")

    def t(a):
        a = np.asarray(a).astype(np.float32)
        return torch.from_numpy(a).to(device=dev, dtype=cfg.compute_dtype)

    b = tree["blocks"][0]
    a, m = b["attn"], b["mlp"]
    blocks = {"pre_norm": t(b["pre_norm"]["scale"]),
              "q_proj": t(a["q_proj"]["kernel"]),
              "k_proj": t(a["k_proj"]["kernel"]),
              "v_proj": t(a["v_proj"]["kernel"]),
              "o_proj": t(a["o_proj"]["kernel"]),
              "mlp_norm": t(b["mlp_norm"]["scale"]),
              "up": t(m["up"]["kernel"]), "down": t(m["down"]["kernel"])}
    if cfg.qk_norm:
        blocks["q_norm"] = t(a["q_norm"]["scale"])
        blocks["k_norm"] = t(a["k_norm"]["scale"])
    if cfg.gated_mlp:
        blocks["gate"] = t(m["gate"]["kernel"])
    n = blocks["q_proj"].shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"checkpoint has {n} layers, config {cfg.n_layers}")
    params = {"embed": t(tree["embed"]["table"]),
              "final_norm": t(tree["final_norm"]["scale"]), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = t(tree["lm_head"]["kernel"])
    return params


def _listify(node):
    """Turn dicts whose keys are all digits back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def load_checkpoint(step_dir: str | Path, *, subtree: str = "") -> dict:
    """Read a ``repro.ckpt`` step directory into a numpy pytree; leaves are
    keyed by their dotted paths in ``manifest.json``. ``subtree`` selects
    the part of the saved state below that dotted prefix (``"params"``
    when the step saved ``{"params": ..., "opt": ...}``)."""
    step_dir = Path(step_dir)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    root: dict = {}
    for leaf in manifest["leaves"]:
        arr = np.load(step_dir / leaf["file"], allow_pickle=False)
        if list(arr.shape) != leaf["shape"]:
            raise ValueError(f"{leaf['file']}: shape {arr.shape} != "
                             f"manifest {leaf['shape']}")
        node = root
        *parents, last = leaf["key"].split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = arr
    tree = _listify(root)
    for k in filter(None, subtree.split(".")):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree
