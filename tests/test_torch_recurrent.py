"""The port's Mamba-1 path (``repro_torch.models.recurrent``, the
``lru_scan`` kernel's plain version, per-slot recurrent state, the engine)
against the JAX package's.

Parameters come from ``repro.models.init(jax.random.PRNGKey(0), cfg)`` at
the shape of ``tests/test_serve.py::_mamba_cfg`` (reduced falcon-mamba-7b:
2 layers, d_model 64, d_inner 128, d_state 8, dt_rank 16, ssm chunk 16,
vocab 256, float32) and are converted with ``repro_torch.convert``; inputs
are numpy arrays from fixed seeds. Sequences are longer than the ssm chunk
of 16, so the chunk loop of ``_ssm_scan_chunked`` and the carry folded into
``b_0`` by ``diag_scan`` both run.

Tolerances, float32 throughout: the recurrence and the Mamba block agree
to atol/rtol 1e-5 (the same math in another order: JAX may contract a
multiply and add into one FMA, and its einsums sum in another order, which
leaves errors near 1e-6); the causal convolution agrees exactly (the same
adds in the same order); model logits and states to atol 1e-4, as
``test_torch_model.py`` holds the dense model. The served tokens are held
to the JAX model path (``extend_step`` in the engine's chunks, then
``decode_step``) teacher-forced, by the margin rule of
``test_torch_serve.py``.

The JAX references run under ``jax.jit``, compiled once per shape.
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
from repro.models import recurrent as jrec
from repro.models.cache import cache_bytes as jcache_bytes
from repro.models.cache import init_cache as jinit_cache
from repro.models.cache import kv_block_bytes as jkv_block_bytes
from repro.models.layers import causal_conv1d as jcausal_conv1d
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import convert_params
from repro_torch.kernels import lru_scan as tlru
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, extend_step, forward, logits_fn
from repro_torch.models import recurrent as trec
from repro_torch.models.cache import cache_bytes, init_cache, kv_block_bytes
from repro_torch.models.layers import causal_conv1d
from repro_torch.serve import Request, ServeEngine

TOL = 1e-5
ATOL = 1e-4
MARGIN = 1e-3
#: XLA compile options of the JAX references: backend optimisation level 0
#: compiles these small graphs several times faster and computes the same
#: float operations
FAST_COMPILE = {"xla_backend_optimization_level": 0}
SMALL = dict(n_layers=2, d_model=64, vocab_size=256, dtype="float32")
ENGINE = dict(max_slots=3, max_len=64, prefill_chunk=20, device="cpu")


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_arch("falcon-mamba-7b")).replace(**SMALL)
    cfg = reduced(get_arch("falcon-mamba-7b")).replace(**SMALL)
    jparams = jax.jit(jinit, static_argnums=1, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, cfg, jparams, params


_jextend = jax.jit(jextend_step, static_argnums=1,
                   compiler_options=FAST_COMPILE)
_jdecode = jax.jit(jdecode_step, static_argnums=1,
                   compiler_options=FAST_COMPILE)
_jlru_ref = jax.jit(jref.lru_scan_ref, compiler_options=FAST_COMPILE)


@functools.partial(jax.jit, compiler_options=FAST_COMPILE)
def _jdiag_scan(a, b, h0):
    return jrec.diag_scan(a, b, h0, 16)


@functools.partial(jax.jit, compiler_options=FAST_COMPILE)
def _jdiag_scan_kernel(a, b, h0):
    with use_backend("interpret"):     # the carry folded, then lru_scan
        return jrec.diag_scan(a, b, h0, 16)


@functools.partial(jax.jit, static_argnames=("jcfg", "single_step",
                                             "valid_len"),
                   compiler_options=FAST_COMPILE)
def _jmamba(p, x, h, conv, *, jcfg, single_step, valid_len):
    state = None if h is None else {"h": h, "conv": conv}
    return jrec.mamba_forward(p, jcfg, x, state=state,
                              compute_dtype=jnp.float32,
                              single_step=single_step, valid_len=valid_len)


def _recurrence_inputs(rng, shape):
    """a in (0.5, 1), as exp(dt * A) lies in (0, 1), and b normal."""
    return (rng.uniform(0.5, 1.0, shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


# --------------------------------------------------------------------------
# lru_scan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,L,D", [(1, 37, 200), (2, 40, 384),
                                   (3, 5, 1000)])
def test_lru_scan_plain_matches_jax(B, L, D):
    a, b = _recurrence_inputs(np.random.default_rng(L * D), (B, L, D))
    got = ops.lru_scan(_t(a), _t(b))
    assert got.shape == (B, L, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(_jlru_ref(a, b)), atol=TOL,
                               rtol=TOL)
    with use_backend("interpret"):   # the Pallas kernel, L and D padded
        want = jops.lru_scan(jnp.asarray(a), jnp.asarray(b), block_d=128,
                             chunk=16)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=TOL)


def test_lru_scan_validate_and_launch_geometry():
    for B, D in ((1, 131072), (3, 1000), (64, 131072), (2, 1)):
        grid = tlru.launch_geometry(B, D)
        tiles = grid // B
        assert grid % B == 0 and (tiles - 1) * tlru.THREADS < D <= (
            tiles * tlru.THREADS)
    # B * L * D passes 2^31 on a full-width forward of 64 rows: dims and
    # offsets cross and live as 64-bit integers
    assert 64 * 256 * 131072 > 2 ** 31 - 1
    assert tlru.launch_geometry(64, 131072) <= tlru.MAX_GRID_X
    argtypes = tlru.KERNEL.funcs["lru_scan_f32"]
    assert argtypes[3:7] == [ctypes.c_longlong] * 4
    a = torch.zeros(2, 5, 7)
    tlru.validate(a, a)
    for bad, match in (((a, a[:, :4]), "shape"),
                       ((a[0], a[0]), "shape"),
                       ((a.double(), a.double()), "float32"),
                       ((a.transpose(1, 2), a.transpose(1, 2)),
                        "contiguous"),
                       ((a[:, :0], a[:, :0]), "empty")):
        with pytest.raises(ValueError, match=match):
            ops.lru_scan(*bad)
    before = [k.launches for k in ops.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        tlru.lru_scan_cuda(a, a)
    ops.lru_scan(a, a)
    assert [k.launches for k in ops.KERNELS] == before


# --------------------------------------------------------------------------
# causal_conv1d, diag_scan, the Mamba block
# --------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("valid_len", [None, 7])
def test_causal_conv1d_matches_jax_exactly(with_state, valid_len):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    state = (rng.standard_normal((2, 3, 24)).astype(np.float32)
             if with_state else None)
    y, new = causal_conv1d(_t(x), _t(w), None if state is None
                           else _t(state), valid_len=valid_len)
    jy, jnew = jcausal_conv1d(jnp.asarray(x), jnp.asarray(w),
                              None if state is None else jnp.asarray(state),
                              valid_len=valid_len)
    np.testing.assert_array_equal(y.numpy(), _np(jy))
    np.testing.assert_array_equal(new.numpy(), _np(jnew))


def test_diag_scan_with_carry_matches_jax():
    rng = np.random.default_rng(2)
    a, b = _recurrence_inputs(rng, (2, 37, 96))
    h0 = rng.standard_normal((2, 96)).astype(np.float32)
    h, last = trec.diag_scan(_t(a), _t(b), _t(h0))
    for fn in (_jdiag_scan, _jdiag_scan_kernel):
        jh, jlast = fn(a, b, h0)
        np.testing.assert_allclose(h.numpy(), _np(jh), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(last.numpy(), _np(jlast), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(trec.diag_scan_step(_t(a[:, 0]), _t(b[:, 0]),
                                                   _t(h0)).numpy(),
                               h[:, 0].numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode", ["full", "extend", "single"])
def test_mamba_forward_matches_jax(model, mode):
    """Layer 0's Mamba block from zero state over 37 tokens (three ssm
    chunks), from a given state over a 20-token chunk whose first 13 are
    real, and one decode step from a given state."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(3)
    B, L, valid_len = {"full": (2, 37, None), "extend": (1, 20, 13),
                       "single": (2, 1, None)}[mode]
    x = rng.standard_normal((B, L, 64)).astype(np.float32)
    DI, N = cfg.d_inner, cfg.ssm.d_state
    h = conv = None
    if mode != "full":
        h = rng.standard_normal((B, DI * N)).astype(np.float32)
        conv = rng.standard_normal((B, 3, DI)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mamba"])
    lp = {k: v[0] for k, v in params["blocks"].items()}
    single = mode == "single"
    want, wstate = _jmamba(jp, x, h, conv, jcfg=jcfg, single_step=single,
                           valid_len=valid_len)
    got, state = trec.mamba_forward(
        lp, cfg, _t(x), state=None if h is None else
        {"h": _t(h), "conv": _t(conv)}, single_step=single,
        valid_len=valid_len)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(state[name].numpy(), _np(wstate[name]),
                                   atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_forward_logits_match_jax(model):
    jcfg, cfg, jparams, params = model
    toks = np.random.default_rng(4).integers(0, 256, (2, 37)).astype(
        np.int32)
    want = jax.jit(lambda p, t: jlogits_fn(p, jcfg, jforward(p, jcfg, t)[0]),
                   compiler_options=FAST_COMPILE)(jparams, jnp.asarray(toks))
    got = logits_fn(params, cfg, forward(params, cfg, _t(toks).long()))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_state_sizing_matches_jax(model):
    jcfg, cfg, _, _ = model
    assert kv_block_bytes(cfg, 8) == jkv_block_bytes(jcfg, 8) == 0
    cache = init_cache(cfg, 1, 8, torch.device("cpu"), slots=3)
    assert set(cache) == {"h", "conv"}
    assert cache_bytes(cache) == jcache_bytes(jinit_cache(jcfg, 3, 64))
    with pytest.raises(ValueError, match="slots"):
        init_cache(cfg, 1, 8, torch.device("cpu"))


def test_decode_step_needs_the_slots(model):
    """A Mamba decode step reads and writes state rows by slot index, so it
    is refused without them (rows 0..B-1 would be a silent guess)."""
    _, cfg, _, params = model
    cache = init_cache(cfg, 1, 8, torch.device("cpu"), slots=2)
    tables = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="slot"):
        decode_step(params, cfg, cache, torch.zeros((1, 1), dtype=torch.long),
                    torch.zeros(1, dtype=torch.long), tables)


def _states_close(cache, jcache, slots):
    rec = jcache["blocks"][0]["rec"]
    for name in ("h", "conv"):
        np.testing.assert_allclose(cache[name][:, slots].numpy(),
                                   _np(rec[name])[:, slots], atol=ATOL)


def test_extend_and_decode_steps_match_jax(model):
    """Three slots: prompts of 45, 13 and 26 tokens prefilled in chunks of
    20 (each longer than the ssm chunk of 16); two decode steps with slot 2
    idle, whose state must not move; one with all three; then slot 1 is
    reused for a new prompt, which must start from zero state; a last
    decode step over all three. Logits and states after every step agree
    with the reference's."""
    jcfg, cfg, jparams, params = model
    chunk, S = ENGINE["prefill_chunk"], 3
    rng = np.random.default_rng(5)
    jcache = jinit_cache(jcfg, S, ENGINE["max_len"])
    cache = init_cache(cfg, 1, 8, torch.device("cpu"), slots=S)
    tables = torch.zeros((S, 1), dtype=torch.int32)
    pos = np.zeros(S, np.int32)

    def prefill(slot, prompt):
        for off in range(0, len(prompt), chunk):
            t = min(chunk, len(prompt) - off)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :t] = prompt[off:off + t]
            nonlocal jcache
            want, jcache = _jextend(jparams, jcfg, jcache, jnp.asarray(buf),
                                    jnp.int32(off), jnp.int32(t),
                                    jnp.int32(slot))
            got = extend_step(params, cfg, cache, _t(buf[:, :t]).long(),
                              off, slot, tables)
            np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)
            _states_close(cache, jcache, [slot])
        pos[slot] = len(prompt)

    def decode(active):
        nonlocal jcache
        feed = rng.integers(0, 256, (S, 1)).astype(np.int32)
        before = {k: v.clone() for k, v in cache.items()}
        want, jcache = _jdecode(jparams, jcfg, jcache, jnp.asarray(feed),
                                jnp.asarray(pos),
                                active=jnp.asarray(active))
        slots = np.nonzero(active)[0]
        got = decode_step(params, cfg, cache, _t(feed[slots]).long(),
                          _t(pos[slots]).long(), tables[slots],
                          slots=_t(slots))
        np.testing.assert_allclose(got.numpy(), _np(want)[slots], atol=ATOL)
        _states_close(cache, jcache, list(range(S)))
        for name, t in cache.items():   # idle slots keep their state
            idle = np.nonzero(~np.asarray(active))[0]
            assert torch.equal(t[:, idle], before[name][:, idle])
        pos[slots] += 1

    for slot, n in enumerate((45, 13, 26)):
        prefill(slot, rng.integers(0, 256, n).astype(np.int32))
    decode(np.array([True, True, False]))
    decode(np.array([True, True, False]))
    decode(np.array([True, True, True]))
    prefill(1, rng.integers(0, 256, 7).astype(np.int32))   # slot reuse
    decode(np.array([True, True, True]))


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
def _requests(n, seed, lo=17, hi=42, new_lo=2, new_hi=7):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 256, rng.integers(lo, hi)),
                    max_new_tokens=int(rng.integers(new_lo, new_hi)))
            for i in range(n)]


def _reference_logits(jcfg, jparams, prompt, tokens):
    """The JAX model path for one request alone, in slot 0 of a cache of
    ``max_slots`` slots (the shapes of the model-level test, so the
    compiled steps are shared): ``extend_step`` over the prompt in the
    engine's chunks, then ``decode_step`` fed the served tokens with the
    other slots inactive. Row i scores the token at len(prompt) + i."""
    chunk, S = ENGINE["prefill_chunk"], ENGINE["max_slots"]
    cache = jinit_cache(jcfg, S, ENGINE["max_len"])
    prompt = np.asarray(prompt, np.int32)
    for off in range(0, len(prompt), chunk):
        t = min(chunk, len(prompt) - off)
        buf = np.zeros((1, chunk), np.int32)
        buf[0, :t] = prompt[off:off + t]
        lg, cache = _jextend(jparams, jcfg, cache, jnp.asarray(buf),
                             jnp.int32(off), jnp.int32(t), jnp.int32(0))
    rows = [_np(lg)[0, 0]]
    feed, pos = np.zeros((S, 1), np.int32), np.zeros(S, np.int32)
    active = np.arange(S) == 0
    for i, tok in enumerate(tokens[:-1]):
        feed[0], pos[0] = tok, len(prompt) + i
        lg, cache = _jdecode(jparams, jcfg, cache, jnp.asarray(feed),
                             jnp.asarray(pos), active=jnp.asarray(active))
        rows.append(_np(lg)[0, 0])
    return np.stack(rows)


def _assert_leak_free(engine):
    assert engine.allocator.n_free == engine.allocator.capacity
    assert not engine.phase.any() and not engine.block_tables.any()
    assert not engine._tables.any()


def test_served_tokens_hold_to_the_jax_reference(model):
    """Six requests on three slots (so three slots are reused), prompts of
    17-41 tokens in chunks of 20: every served token within MARGIN of the
    reference's best logit, and its argmax where the top-1/top-2 gap
    exceeds MARGIN."""
    jcfg, cfg, jparams, params = model
    reqs = _requests(6, seed=0)
    engine = ServeEngine(cfg, params, **ENGINE)
    assert set(engine.cache) == {"h", "conv"}
    results = engine.run(reqs)
    gated = total = 0
    for req, res in zip(reqs, results):
        assert res.finish_reason == "length"
        assert len(res.tokens) == req.max_new_tokens == res.decode_steps + 1
        ref = _reference_logits(jcfg, jparams, req.prompt, res.tokens)
        for i, (row, tok) in enumerate(zip(ref, res.tokens)):
            top2 = np.sort(row)[-2:]
            assert row[tok] >= top2[1] - MARGIN, (req.uid, i)
            if top2[1] - top2[0] > MARGIN:
                assert tok == int(row.argmax()), (req.uid, i)
                gated += 1
            total += 1
    assert gated >= total - 2, (gated, total)
    assert engine.stats["prefills"] == 6
    assert engine.stats["prefill_chunks"] == sum(
        -(-len(r.prompt) // ENGINE["prefill_chunk"]) for r in reqs)
    _assert_leak_free(engine)


def test_admission_needs_a_slot_only_and_drains_leak_free(model):
    """With no pool, admission waits for a free slot, first come first
    served; a request over max_len is rejected; the drain frees every
    slot."""
    _, cfg, _, params = model
    reqs = _requests(5, seed=1, new_lo=4, new_hi=7)
    too_long = Request(uid=9, prompt=np.zeros(60, np.int64),
                       max_new_tokens=8)
    engine = ServeEngine(cfg, params, **ENGINE)
    assert not engine.paged and engine.allocator.capacity == 0
    admitted = []
    for r in reqs[:2] + [too_long] + reqs[2:]:
        engine.submit(r)
    while engine.queue or engine.phase.any():
        engine.step()
        assert (engine.phase != 0).sum() <= ENGINE["max_slots"]
        admitted += [r.uid for r in engine._slot_req
                     if r is not None and r.uid not in admitted]
    assert admitted == [r.uid for r in reqs]
    assert engine.results[9].finish_reason == "rejected"
    assert all(len(engine.results[r.uid].tokens) == r.max_new_tokens
               for r in reqs)
    _assert_leak_free(engine)


def test_launcher_serves_falcon_mamba_on_cpu(capsys):
    launch_serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                       "cpu", "--requests", "2", "--max-new", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "falcon-mamba-7b-smoke"
    assert out["finished"] == 2 and out["new_tokens"] == 6


def test_mamba_config_guards():
    cfg = get_arch("falcon-mamba-7b")
    for bad in (dict(weight_dtype="int8"), dict(kv_dtype="fp8")):
        with pytest.raises(NotImplementedError, match="recurrent"):
            cfg.replace(**bad)
    with pytest.raises(NotImplementedError):
        cfg.replace(ssm=None)
    with pytest.raises(NotImplementedError):
        cfg.replace(pattern=cfg.pattern + get_arch("qwen3-0.6b").pattern)
    small = reduced(cfg)
    assert (small.n_heads, small.n_kv_heads, small.resolved_head_dim) == (
        0, 0, 0)
    assert dataclasses.astuple(small.ssm) == (8, 4, 2, 16, 16)
