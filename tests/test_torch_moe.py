"""The port's mixture-of-experts path (``repro_torch.models.moe``, the
``packed_gather_rows`` kernel's plain version, the MoE layer in the model
and the engine) against the JAX package's.

Parameters fill the tree of ``repro.models.init`` at
``reduced(qwen2-moe-a2.7b)`` in float32 (2 layers, d_model 128, 4 heads of
32, 8 experts of width 64, top 2 without renormalisation, a gated shared
expert of width 128, capacity factor 1.25, vocab 512): its leaves' shapes
and dtypes are read with ``jax.eval_shape`` (nothing is compiled) and drawn
with numpy, kernels normal / sqrt(fan_in) and norm scales nonzero. They are
converted with ``repro_torch.convert``; inputs are numpy arrays from fixed
seeds.

Routing is held exactly: the chosen experts must be equal, and every case
asserts that each token's k-th and (k+1)-th router probabilities are more
than 1e-5 apart, so that rounding cannot flip a choice. The layer cases
assert that the capacity dropped at least one assignment, so the drop
rule itself is compared. Tolerances, float32 throughout: the packed
gather is exact; the MoE layer agrees to atol/rtol 1e-5 (the same math
with sums in another order, errors near 1e-6); model logits to atol 1e-4,
as ``test_torch_model.py`` holds the dense model. The served tokens are
held by the margin rule of ``test_torch_serve.py`` to the JAX
``extend_step`` / ``decode_step`` replaying the engine's recorded steps
with the same row sets, teacher-forced on the served tokens; the JAX
engine is not the reference (it decodes its whole slot pool, idle rows
included, which moves a MoE model's capacity drops).

The JAX references run under ``jax.jit`` at XLA backend optimisation level
0, compiled once per shape; a reference that runs a Pallas kernel in
interpret mode enters ``use_backend("interpret")`` inside the jitted
function.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dispatch import use_backend
from repro.models import decode_step as jdecode_step
from repro.models import extend_step as jextend_step
from repro.models import forward as jforward
from repro.models import init as jinit
from repro.models import logits_fn as jlogits_fn
from repro.models import moe as jmoe
from repro.models.cache import init_cache as jinit_cache
from repro_torch.configs import LayerSpec, ModelConfig, get_arch, reduced
from repro_torch.convert import convert_params
from repro_torch.kernels import ops
from repro_torch.kernels import packed_gather as tpg
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (decode_step, extend_step, forward, init,
                                logits_fn)
from repro_torch.models import moe as tmoe
from repro_torch.models.cache import init_cache
from repro_torch.serve import Request, ServeEngine

TOL = 1e-5
ATOL = 1e-4
MARGIN = 1e-3
#: least gap between a token's k-th and (k+1)-th router probability
GAP = 1e-5
#: XLA compile options of the JAX references: backend optimisation level 0
#: compiles these small graphs several times faster and computes the same
#: float operations
FAST_COMPILE = {"xla_backend_optimization_level": 0}
ENGINE = dict(max_slots=2, max_len=40, page_size=8, prefill_chunk=8,
              device="cpu")
#: the JAX pools of the model-level tests: one block per page of each of
#: the engine test's 6 requests and the null block, so that the extend and
#: decode references compile once for both tests
PAGES = -(-ENGINE["max_len"] // ENGINE["page_size"])
N_BLOCKS = 1 + 6 * PAGES


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_params(jcfg, seed: int = 0) -> dict:
    """The reference's parameter tree, filled from numpy: leaves named
    ``scale`` (norms) 0.1 * normal, the embedding table normal /
    sqrt(d_model), every other kernel normal / sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(leaf.shape)
        if name == "scale":
            x = 0.1 * x
        else:
            x = x / np.sqrt(leaf.shape[-1 if name == "table" else -2])
        return jnp.asarray(x.astype(leaf.dtype))

    shapes = jax.eval_shape(lambda key: jinit(key, jcfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_arch("qwen2-moe-a2.7b")).replace(dtype="float32")
    cfg = reduced(get_arch("qwen2-moe-a2.7b")).replace(dtype="float32")
    jparams = _jax_params(jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, cfg, jparams, params


def _layer0(jparams, params):
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["moe"])
    return jp, {k: v[0] for k, v in params["blocks"].items()}


_jextend = jax.jit(jextend_step, static_argnums=1,
                   compiler_options=FAST_COMPILE)
_jdecode = jax.jit(jdecode_step, static_argnums=1,
                   compiler_options=FAST_COMPILE)
_jgather_ref = jax.jit(jref.gather_rows_ref, compiler_options=FAST_COMPILE)


@functools.partial(jax.jit, compiler_options=FAST_COMPILE)
def _jgather_kernel(table, idx):
    with use_backend("interpret"):   # sort, Pallas pack of 8, un-permute
        return jops.packed_gather_rows(table, idx)


@functools.partial(jax.jit, static_argnums=0, compiler_options=FAST_COMPILE)
def _jroute(m, p, x):
    return jmoe._route(p, m, x)[:2]


@functools.partial(jax.jit, static_argnums=0, compiler_options=FAST_COMPILE)
def _jmoe(jcfg, p, x):
    with use_backend("interpret"):   # the Pallas packed gather and gemm
        return jmoe.moe_forward(p, jcfg, x, compute_dtype=jnp.float32)[0]


@functools.partial(jax.jit, static_argnums=0, compiler_options=FAST_COMPILE)
def _jlogits(jcfg, p, toks):
    return jlogits_fn(p, jcfg, jforward(p, jcfg, toks)[0])


def _clustered(rng, shape, spread=0.5):
    """Rows around one common direction, so that tokens pick overlapping
    experts and capacity drops happen."""
    base = rng.standard_normal(shape[-1]).astype(np.float32)
    return (base + spread * rng.standard_normal(shape)).astype(np.float32)


def _assert_clear_choices(probs: torch.Tensor, k: int) -> None:
    top = probs.topk(k + 1, dim=-1).values
    gap = (top[..., k - 1] - top[..., k]).min().item()
    assert gap > GAP, f"a k-th/(k+1)-th router gap of {gap:.2e}"


def _drops(idx: torch.Tensor, C: int, E: int) -> int:
    """Assignments past their expert's capacity, over all groups of idx
    (G, T, k)."""
    counts = torch.stack([torch.bincount(g.reshape(-1), minlength=E)
                          for g in idx])
    return int((counts - C).clamp_min(0).sum())


# --------------------------------------------------------------------------
# packed_gather_rows
# --------------------------------------------------------------------------
@pytest.mark.parametrize("N,D,M,dtype", [(64, 128, 256, np.float32),
                                         (1000, 100, 37, np.float32),
                                         (9, 6, 5, np.float16)])
def test_packed_gather_plain_matches_jax_exactly(N, D, M, dtype):
    """Against JAX's plain gather, and at a prefill chunk's 256 rows
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(N * D + M)
    table = rng.standard_normal((N, D)).astype(dtype)
    idx = rng.integers(0, N, M)
    for idx_dtype in (np.int32, np.int64):
        got = ops.packed_gather_rows(_t(table), _t(idx.astype(idx_dtype)))
        assert got.shape == (M, D) and got.dtype == _t(table).dtype
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(_jgather_ref(table, idx.astype(
                np.int32))))
    if M == 256:
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            _jgather_kernel(table, idx.astype(np.int32))))


def test_packed_gather_clamps_like_jnp_indexing():
    table = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    idx = np.array([-1, -5, -7, 5, 9, 2, 0], np.int32)
    got = ops.packed_gather_rows(_t(table), _t(idx))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_jgather_ref(table, idx)))
    got = ops.packed_gather_rows(_t(table).bfloat16(), _t(idx).long())
    np.testing.assert_array_equal(got.float().numpy(), table[[4, 0, 0, 4, 4,
                                                             2, 0]])


def test_packed_gather_validate_and_launch_geometry():
    for M in (1, 8, 9, 256, 2 ** 20 + 3):
        grid = tpg.launch_geometry(M)
        assert (grid - 1) * tpg.PACK < M <= grid * tpg.PACK
    # 16-byte units where the row width and both addresses allow, else
    # the widest that does
    assert tpg.copy_unit(4096, 0, 256) == 16
    assert tpg.copy_unit(400, 16, 32) == 16
    assert tpg.copy_unit(200, 16, 32) == 8
    assert tpg.copy_unit(4096, 4, 256) == 4
    assert tpg.copy_unit(6, 0, 0) == 2 and tpg.copy_unit(3, 0, 0) == 1
    # N, M, the row's bytes and the grid cross as 64-bit integers
    argtypes = tpg.KERNEL.funcs["packed_gather_rows"]
    assert [argtypes[i] for i in (3, 4, 5, 8)] == [ctypes.c_longlong] * 4
    assert argtypes[6:8] == [ctypes.c_int] * 2
    t, i = torch.zeros(4, 6), torch.zeros(3, dtype=torch.long)
    tpg.validate(t, i)
    for bad, match in (((t[0], i), "expected"),
                       ((t, i[None]), "expected"),
                       ((t.double(), i), "dtype"),
                       ((t.int(), i), "dtype"),
                       ((t, i.float()), "int32 or int64"),
                       ((t.T, i), "contiguous"),
                       ((t[:, :0], i), "empty"),
                       ((t, i[:0]), "empty")):
        with pytest.raises(ValueError, match=match):
            ops.packed_gather_rows(*bad)
    before = [k.launches for k in ops.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        tpg.packed_gather_rows_cuda(t, i)
    ops.packed_gather_rows(t, i)
    assert [k.launches for k in ops.KERNELS] == before
    assert tpg.KERNEL in ops.KERNELS and len(ops.KERNELS) == 7
    assert tpg.KERNEL.source.name == "packed_gather.cu"


# --------------------------------------------------------------------------
# routing, capacity and the MoE layer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("T", [1, 3, 4, 8, 12, 64, 215])
def test_capacity_matches_jax(model, T):
    jcfg, cfg, _, _ = model
    for jm, m in ((jcfg.moe, cfg.moe), (jget_arch("qwen2-moe-a2.7b").moe,
                                        get_arch("qwen2-moe-a2.7b").moe)):
        assert tmoe.capacity(m, T) == jmoe.capacity(jm, T)
    # qwen2-moe-a2.7b keeps one assignment per expert at a decode of up to
    # 12 rows, and 6 at a prefill chunk of 64
    full = get_arch("qwen2-moe-a2.7b").moe
    assert tmoe.capacity(full, 12) == 1 and tmoe.capacity(full, 64) == 6


@pytest.mark.parametrize("shape", [(2, 12), (1, 64)])
def test_route_matches_jax(model, shape):
    jcfg, cfg, jparams, params = model
    jp, lp = _layer0(jparams, params)
    x = _clustered(np.random.default_rng(sum(shape)), shape + (128,))
    gate, idx = tmoe._route(lp, cfg.moe, _t(x))
    probs = torch.softmax(_t(x) @ lp["router"], dim=-1)
    _assert_clear_choices(probs, cfg.moe.top_k)
    jgate, jidx = _jroute(jcfg.moe, jp, x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), _np(jgate), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S", [(2, 8), (3, 1)])
def test_moe_forward_matches_jax_with_drops(model, B, S):
    """Prefill groups (one per batch row) and a decode group (all rows in
    one), with at least one assignment dropped by capacity."""
    jcfg, cfg, jparams, params = model
    jp, lp = _layer0(jparams, params)
    x = _clustered(np.random.default_rng(10 * B + S), (B, S, 128))
    G = B if S > 1 else 1
    xg = _t(x).reshape(G, B * S // G, 128)
    _assert_clear_choices(torch.softmax(xg @ lp["router"], -1),
                          cfg.moe.top_k)
    _, idx = tmoe._route(lp, cfg.moe, xg)
    C = tmoe.capacity(cfg.moe, xg.shape[1])
    assert _drops(idx, C, cfg.moe.n_experts) > 0
    got = tmoe.moe_forward(lp, cfg, _t(x))
    assert got.shape == (B, S, 128)
    np.testing.assert_allclose(got.numpy(), _np(_jmoe(jcfg, jp, x)),
                               atol=TOL, rtol=TOL)


def test_padded_chunk_routes_with_the_padded_capacity(model):
    """A ragged last chunk of 3 valid rows, padded to 8 as the reference
    pads it (batch row 0 of the reference's input; row 1 is a second,
    full chunk): the port routes the valid rows with capacity_tokens=8 and
    matches the reference's valid rows, though the pad rows are copies of
    the valid ones and so compete for the same experts. Routed with its
    own length (C = 1, not 3) the chunk drops assignments and differs."""
    jcfg, cfg, jparams, params = model
    jp, lp = _layer0(jparams, params)
    rng = np.random.default_rng(7)
    valid = _clustered(rng, (1, 3, 128))
    padded = np.concatenate([
        np.concatenate([valid, valid, valid[:, :2]], axis=1),
        _clustered(rng, (1, 8, 128))])
    _assert_clear_choices(torch.softmax(_t(valid) @ lp["router"], -1),
                          cfg.moe.top_k)
    _, idx = tmoe._route(lp, cfg.moe, _t(valid))
    E = cfg.moe.n_experts
    assert tmoe.capacity(cfg.moe, 3) == 1 and tmoe.capacity(cfg.moe, 8) == 3
    assert _drops(idx, 1, E) > 0 and _drops(idx, 3, E) == 0
    want = _np(_jmoe(jcfg, jp, padded))[:1, :3]
    got = tmoe.moe_forward(lp, cfg, _t(valid), capacity_tokens=8)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    unpadded = tmoe.moe_forward(lp, cfg, _t(valid))
    assert np.abs(unpadded.numpy() - want).max() > 1e-3
    with pytest.raises(ValueError, match="capacity_tokens"):
        tmoe.moe_forward(lp, cfg, _t(valid), capacity_tokens=2)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_init_matches_the_converted_layout(model):
    _, cfg, _, params = model
    mine = init(cfg, seed=0, device="cpu")
    assert mine["blocks"].keys() == params["blocks"].keys()
    for k, v in params["blocks"].items():
        assert mine["blocks"][k].shape == v.shape, k
        assert mine["blocks"][k].dtype == v.dtype, k
    bf = init(cfg.replace(dtype="bfloat16"), seed=0, device="cpu")["blocks"]
    assert bf["router"].dtype == torch.float32
    assert bf["experts_gate"].dtype == torch.bfloat16


def test_forward_logits_match_jax(model):
    jcfg, cfg, jparams, params = model
    toks = np.random.default_rng(2).integers(0, 512, (2, 13)).astype(np.int32)
    want = _jlogits(jcfg, jparams, toks)
    got = logits_fn(params, cfg, forward(params, cfg, _t(toks).long()))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_extend_step_pads_like_jax(model):
    """A prompt of 11 tokens in chunks of 8 (the second ragged, 3 valid),
    then a decode step of both slots and one of slot 0 alone: logits agree
    with the reference's paged path, which pads the ragged chunk behind
    n_valid."""
    jcfg, cfg, jparams, params = model
    page, chunk = ENGINE["page_size"], ENGINE["prefill_chunk"]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (11, 5)]
    tables = np.zeros((2, PAGES), np.int32)
    tables[0, :2], tables[1, :1] = [5, 2], [7]
    jcache = jinit_cache(jcfg, 2, ENGINE["max_len"], n_blocks=N_BLOCKS,
                         page_size=page)
    cache = init_cache(cfg, N_BLOCKS, page, torch.device("cpu"))
    for slot, prompt in enumerate(prompts):
        for off in range(0, len(prompt), chunk):
            t = min(chunk, len(prompt) - off)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :t] = prompt[off:off + t]
            want, jcache = _jextend(
                jparams, jcfg, jcache, jnp.asarray(buf), jnp.int32(off),
                jnp.int32(t), jnp.int32(slot),
                block_tables=jnp.asarray(tables))
            got = extend_step(params, cfg, cache, _t(buf[:, :t]).long(), off,
                              slot, _t(tables), padded_len=chunk)
            np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
    pos = np.array([len(p) for p in prompts], np.int32)
    feed = np.array([[17], [42]], np.int32)
    for rows in (2, 1):
        want, jcache = _jdecode(
            jparams, jcfg, jcache, jnp.asarray(feed[:rows]),
            jnp.asarray(pos[:rows]), active=jnp.ones(rows, bool),
            block_tables=jnp.asarray(tables[:rows]))
        got = decode_step(params, cfg, cache, _t(feed[:rows]).long(),
                          _t(pos[:rows]).long(), _t(tables[:rows]))
        np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
        pos, feed = pos + 1, feed + 1
    with pytest.raises(ValueError, match="padded_len"):
        extend_step(params, cfg, cache, _t(buf).long(), 0, 0, _t(tables),
                    padded_len=chunk - 1)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
def _requests(n, seed, lo=5, hi=21, new_lo=2, new_hi=7):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 512, rng.integers(lo, hi)),
                    max_new_tokens=int(rng.integers(new_lo, new_hi)))
            for i in range(n)]


def _replay(jcfg, jparams, engine, reqs, results):
    """The engine's recorded steps through the JAX ``extend_step`` (each
    chunk padded to ``prefill_chunk`` behind ``n_valid``) and
    ``decode_step`` (the same rows, teacher-forced on the served tokens),
    each request in pages of its own. Returns, per uid, the logits before
    each served token."""
    chunk, page = engine.prefill_chunk, engine.page_size
    P = engine.n_pages
    assert len(reqs) * P < N_BLOCKS
    jcache = jinit_cache(jcfg, engine.max_slots, engine.max_len,
                         n_blocks=N_BLOCKS, page_size=page)
    tables = np.zeros((engine.max_slots, P), np.int32)
    prompts = {r.uid: np.asarray(r.prompt, np.int32) for r in reqs}
    tokens = {r.uid: r.tokens for r in results}
    rows = {r.uid: [] for r in reqs}
    for step in engine.steps:
        if step[0] == "prefill_chunk":
            _, uid, slot, off, n = step
            if off == 0:
                tables[slot] = 1 + uid * P + np.arange(P)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :n] = prompts[uid][off:off + n]
            lg, jcache = _jextend(jparams, jcfg, jcache, jnp.asarray(buf),
                                  jnp.int32(off), jnp.int32(n),
                                  jnp.int32(slot),
                                  block_tables=jnp.asarray(tables))
            if off + n == len(prompts[uid]):
                rows[uid].append(_np(lg)[0, 0])
        else:
            _, uids, slots, pos = step
            feed = np.array([[tokens[u][p - len(prompts[u])]]
                             for u, p in zip(uids, pos)], np.int32)
            lg, jcache = _jdecode(
                jparams, jcfg, jcache, jnp.asarray(feed),
                jnp.asarray(pos, jnp.int32),
                active=jnp.ones(len(uids), bool),
                block_tables=jnp.asarray(tables[slots]))
            for u, row in zip(uids, _np(lg)[:, 0]):
                rows[u].append(row)
    return {u: np.stack(r) for u, r in rows.items()}


def test_served_tokens_hold_to_the_jax_replay_of_their_steps(model):
    """Six requests on two slots, prompts of 5-20 tokens in chunks of 8
    (ragged last chunks), decode steps of one and two rows: every served
    token within MARGIN of the replay's best logit, and its argmax where
    the top-1/top-2 gap exceeds MARGIN."""
    jcfg, cfg, jparams, params = model
    reqs = _requests(6, seed=0)
    engine = ServeEngine(cfg, params, **ENGINE)
    results = engine.run(reqs)
    decodes = [s for s in engine.steps if s[0] == "decode"]
    chunks = [s for s in engine.steps if s[0] == "prefill_chunk"]
    assert len(decodes) == engine.stats["decode_steps"]
    assert len(chunks) == engine.stats["prefill_chunks"] == sum(
        -(-len(r.prompt) // ENGINE["prefill_chunk"]) for r in reqs)
    assert max(len(s[1]) for s in decodes) == ENGINE["max_slots"]
    assert any(n < ENGINE["prefill_chunk"] for *_, n in chunks)
    ref = _replay(jcfg, jparams, engine, reqs, results)
    gated = total = 0
    for req, res in zip(reqs, results):
        assert res.finish_reason == "length"
        assert len(res.tokens) == req.max_new_tokens == res.decode_steps + 1
        assert len(ref[req.uid]) == len(res.tokens)
        for i, (row, tok) in enumerate(zip(ref[req.uid], res.tokens)):
            top2 = np.sort(row)[-2:]
            assert row[tok] >= top2[1] - MARGIN, (req.uid, i)
            if top2[1] - top2[0] > MARGIN:
                assert tok == int(row.argmax()), (req.uid, i)
                gated += 1
            total += 1
    assert gated >= total - 2, (gated, total)
    assert engine.allocator.n_free == engine.allocator.capacity
    assert not engine.phase.any() and not engine.block_tables.any()


# --------------------------------------------------------------------------
# launcher and config guards
# --------------------------------------------------------------------------
def test_launcher_serves_qwen2_moe_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device",
                       "cpu", "--requests", "2", "--max-new", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "qwen2-moe-a2.7b-smoke"
    assert out["finished"] == 2 and out["new_tokens"] == 6


def test_moe_config_guards():
    cfg = get_arch("qwen2-moe-a2.7b")
    assert cfg.is_moe and not cfg.is_ssm
    for bad in (dict(weight_dtype="int8"), dict(kv_dtype="fp8")):
        with pytest.raises(NotImplementedError, match="experts"):
            cfg.replace(**bad)
    with pytest.raises(NotImplementedError):
        cfg.replace(moe=None)
    with pytest.raises(NotImplementedError):   # a dense layer among moe ones
        cfg.replace(pattern=cfg.pattern + (LayerSpec("full", "dense"),))
    with pytest.raises(NotImplementedError):
        ModelConfig(pattern=(LayerSpec("local", "moe"),), moe=cfg.moe)
    with pytest.raises(KeyError, match="not ported"):
        get_arch("deepseek-moe-16b")
    small = reduced(cfg)
    assert dataclasses.astuple(small.moe) == (8, 2, 2, 64, 128, 1.25, False,
                                              True, "float32")
