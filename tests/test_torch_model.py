"""The port's model (``repro_torch.models``) against the JAX package's.

Parameters come from ``repro.models.init(jax.random.PRNGKey(0), cfg)`` and
are converted with ``repro_torch.convert``; inputs are numpy arrays from
fixed seeds. Everything runs in float32 at the shapes of
``tests/test_serve.py::_cfg`` (2 layers, d_model 64, 4/2 heads of 16,
vocab 256). Logits and hidden states agree to atol 1e-4: the two packages
compute the same float32 math and differ only in summation order, which
leaves errors near 1e-6 at these widths. The JAX references run under
``jax.jit``, compiled once per shape (a reference that runs a Pallas kernel
in interpret mode enters that scope inside the jitted function, so the
scope is part of what is traced).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import save_checkpoint
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels.dispatch import use_backend
from repro.models import decode_step as jdecode_step
from repro.models import extend_step as jextend_step
from repro.models import forward as jforward
from repro.models import init as jinit
from repro.models import logits_fn as jlogits_fn
from repro.models.attention import attention_forward as jattention_forward
from repro.models.cache import init_cache as jinit_cache
from repro.models.layers import apply_mlp as japply_mlp
from repro_torch.configs import LayerSpec, ModelConfig, get_arch, reduced
from repro_torch.convert import convert_params, load_checkpoint
from repro_torch.models import (decode_step, extend_step, forward,
                                logits_fn)
from repro_torch.models.attention import attention_forward
from repro_torch.models.cache import init_cache
from repro_torch.models.layers import apply_mlp

ATOL = 1e-4
#: XLA compile options of the JAX references: backend optimisation level 0
#: compiles these small graphs several times faster and computes the same
#: float operations
FAST_COMPILE = {"xla_backend_optimization_level": 0}
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256, dtype="float32")


def _np(x):
    return np.asarray(x, np.float32)


_jextend = jax.jit(jextend_step, static_argnums=1,
                   compiler_options=FAST_COMPILE)
_jdecode = jax.jit(jdecode_step, static_argnums=1,
                   compiler_options=FAST_COMPILE)


@functools.partial(jax.jit, compiler_options=FAST_COMPILE)
def _jmlp(p, x):
    return japply_mlp(p, x, "silu", True, jnp.float32)


@functools.partial(jax.jit, compiler_options=FAST_COMPILE)
def _jmlp_kernel(p, x):
    with use_backend("interpret"):   # through the Pallas gemm, silu fused
        return japply_mlp(p, x, "silu", True, jnp.float32)


@functools.partial(jax.jit, static_argnums=0,
                   compiler_options=FAST_COMPILE)
def _jattention_kernel(jcfg, p, x):
    with use_backend("interpret"):   # through the Pallas flash kernel
        out, _ = jattention_forward(
            p, jcfg.replace(kernel_backend="interpret"), x, is_local=False,
            positions=jnp.arange(x.shape[1])[None],
            compute_dtype=jnp.float32)
    return out


@functools.partial(jax.jit, static_argnums=0,
                   compiler_options=FAST_COMPILE)
def _jlogits(jcfg, p, toks):
    return jlogits_fn(p, jcfg, jforward(p, jcfg, toks)[0])


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_arch("qwen3-0.6b")).replace(**SMALL)
    cfg = reduced(get_arch("qwen3-0.6b")).replace(**SMALL)
    jparams = jax.jit(jinit, static_argnums=1, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, convert_params(tree, cfg, device="cpu")


@pytest.mark.parametrize("make", [lambda m: m.get_arch("qwen3-0.6b"),
                                  lambda m: m.reduced(m.get_arch(
                                      "qwen3-0.6b")),
                                  lambda m: m.get_arch("qwen3-0.6b").replace(
                                      weight_dtype="int4", kv_dtype="fp8",
                                      quant_block=32),
                                  lambda m: m.get_arch("falcon-mamba-7b"),
                                  lambda m: m.reduced(m.get_arch(
                                      "falcon-mamba-7b")),
                                  lambda m: m.get_arch("qwen2-moe-a2.7b"),
                                  lambda m: m.reduced(m.get_arch(
                                      "qwen2-moe-a2.7b"))])
def test_config_copy_matches_reference(make):
    import repro.configs as jc
    import repro_torch.configs as tc
    jcfg, cfg = make(jc), make(tc)
    for f in dataclasses.fields(ModelConfig):
        mine, ref = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "pattern":   # two LayerSpec classes with equal fields
            mine, ref = ([dataclasses.astuple(s) for s in x]
                         for x in (mine, ref))
        if f.name in ("ssm", "moe"):   # two classes each, equal fields
            mine, ref = (x if x is None else dataclasses.astuple(x)
                         for x in (mine, ref))
        assert mine == ref, f.name
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    if cfg.moe is not None:
        assert cfg.moe.shared_hidden == jcfg.moe.shared_hidden


@pytest.mark.parametrize("bad", [dict(weight_dtype="int2"),
                                 dict(kv_dtype="int4"),
                                 dict(quant_block=-1)])
def test_quant_config_validation_matches_reference(bad):
    import repro.configs as jc
    import repro_torch.configs as tc
    for m in (jc, tc):
        with pytest.raises(ValueError):
            m.get_arch("qwen3-0.6b").replace(**bad)


def test_unported_layouts_are_refused():
    with pytest.raises(KeyError, match="not ported"):
        get_arch("gemma2-27b")
    with pytest.raises(NotImplementedError):
        ModelConfig(pattern=(LayerSpec("local", "dense"),))


def test_mlp_matches_jax_gemm_kernel(model):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mlp"])
    lp = {k: v[0] for k, v in params["blocks"].items()}
    got = apply_mlp(lp, torch.from_numpy(x), cfg.act, cfg.gated_mlp)
    assert jcfg.act == "silu"
    np.testing.assert_allclose(got.numpy(), _np(_jmlp(jp, x)), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _np(_jmlp_kernel(jp, x)),
                               atol=ATOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_attention_forward_matches_jax_flash_kernel(model, batch):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((batch, 11, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["attn"])
    lp = {k: v[0] for k, v in params["blocks"].items()}
    got = attention_forward(lp, cfg, torch.from_numpy(x))
    want = _jattention_kernel(jcfg, jp, x)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_forward_logits_match_jax(model):
    jcfg, cfg, jparams, params = model
    toks = np.random.default_rng(2).integers(0, 256, (2, 13)).astype(np.int32)
    want = _jlogits(jcfg, jparams, toks)
    got = logits_fn(params, cfg, forward(params, cfg,
                                         torch.from_numpy(toks).long()))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_extend_and_decode_steps_match_jax_paged(model):
    """Chunked prefill of two slots (14 and 5 tokens, chunks of 6) through
    ``extend_step``, then two ``decode_step``s over both slots: logits and
    the written pool rows agree with the reference's paged path."""
    jcfg, cfg, jparams, params = model
    page, n_blocks, P, chunk = 8, 9, 4, 6
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (14, 5)]
    tables = np.zeros((2, P), np.int32)
    tables[0, :3] = [5, 2, 7]
    tables[1, :2] = [3, 8]
    jcache = jinit_cache(jcfg, 2, P * page, n_blocks=n_blocks,
                         page_size=page)
    cache = init_cache(cfg, n_blocks, page, torch.device("cpu"))
    ttab = torch.from_numpy(tables)
    for slot, prompt in enumerate(prompts):
        for off in range(0, len(prompt), chunk):
            t = min(chunk, len(prompt) - off)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :t] = prompt[off:off + t]
            want, jcache = _jextend(
                jparams, jcfg, jcache, jnp.asarray(buf), jnp.int32(off),
                jnp.int32(t), jnp.int32(slot), block_tables=jnp.asarray(tables))
            got = extend_step(params, cfg, cache,
                              torch.from_numpy(buf[:, :t]).long(), off, slot,
                              ttab)
            np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    pos = np.array([len(p) for p in prompts], np.int32)
    feed = np.array([[17], [42]], np.int32)
    for _ in range(2):
        want, jcache = _jdecode(
            jparams, jcfg, jcache, jnp.asarray(feed), jnp.asarray(pos),
            active=jnp.ones(2, bool), block_tables=jnp.asarray(tables))
        got = decode_step(params, cfg, cache, torch.from_numpy(feed).long(),
                          torch.from_numpy(pos).long(), ttab)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
        feed = np.array(want[:, 0].argmax(-1), np.int32)[:, None]
        pos = pos + 1
    jpool = jcache["blocks"][0]["self"]
    for name in ("k", "v"):
        for slot, n in enumerate(pos):
            rows = [(tables[slot, p // page], p % page) for p in range(n)]
            idx = tuple(np.array(rows).T)
            np.testing.assert_allclose(
                cache[name][:, idx[0], idx[1]].numpy(),
                _np(jpool[name])[:, idx[0], idx[1]], atol=ATOL)


def test_checkpoint_loads_without_repro(model, tmp_path):
    jcfg, cfg, jparams, params = model
    step_dir = save_checkpoint(tmp_path, 3, {"params": jparams})
    loaded = convert_params(load_checkpoint(step_dir, subtree="params"), cfg,
                            device="cpu")
    flat = lambda p: {**{k: v for k, v in p.items() if k != "blocks"},
                      **{"blocks." + k: v for k, v in p["blocks"].items()}}
    a, b = flat(params), flat(loaded)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
