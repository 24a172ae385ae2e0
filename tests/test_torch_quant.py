"""The port's quantized serving path (``repro_torch.quant``, ``gemm_wq``,
quantized paged pools) against the JAX package's.

* The quantizer is held bit for bit against ``repro.quant``: codes (fp8 as
  their bytes) and float16 scales, per channel and per block of 32, on
  normal, all-zero and outlier inputs, and so are nibble packing, KV-row
  quantization, the parameter walk, byte counts and the converter.
* The plain ``gemm_wq`` and quantized ``paged_attention`` are held to the
  JAX plain versions and to the Pallas kernels in interpret mode at atol /
  rtol 1e-5 in float32: the same dequantized math, summed in another order.
* The model, at the ``SMALL`` float32 config of ``test_torch_serve.py``:
  logits with quantized weights within 1e-4 of the JAX ``forward``; and
  each served rung (int8 weights with int8 KV, int4 weights with fp8 KV,
  quant_block 32) held to the JAX paged path (``extend_step`` in the same
  chunks, then ``decode_step``, on ``kv_dtype`` pools), teacher-forced on
  the engine's tokens, request by request.

A KV code is rounded from a value the two frameworks compute with float
noise of ~1e-7 between them, so a code lying within that noise of a
rounding boundary can round the other way in one of them. The serving
test counts such code differences between the port's and JAX's pools
(they must stay under 0.1% of the codes and one step apart), compares
model logits at 1e-4 only while the pools agree exactly, and holds the
served tokens to the reference by MARGIN, which covers one such code
(see ``test_quantized_serving_holds_to_the_jax_paged_path``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
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
from repro.models.cache import init_cache as jinit_cache
from repro.models.cache import kv_block_bytes as jkv_block_bytes
from repro.models.cache import n_blocks_for_bytes as jn_blocks_for_bytes
from repro_torch import quant
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import convert_params
from repro_torch.kernels import gemm_wq as twq
from repro_torch.kernels import ops
from repro_torch.models import decode_step, extend_step, forward, logits_fn
from repro_torch.models.cache import (init_cache, kv_block_bytes,
                                      n_blocks_for_bytes)
from repro_torch.serve import Request, ServeEngine

TOL = 1e-5
ATOL = 1e-4
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256, dtype="float32")
RUNGS = [("int8", "int8"), ("int4", "fp8")]
#: XLA compile options of the JAX references: backend optimisation level 0
#: compiles these small graphs several times faster and computes the same
#: float operations (the quantizers still agree bit for bit)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@functools.partial(jax.jit, static_argnames=("act", "kernel"),
                   compiler_options=FAST_COMPILE)
def _jgemm_wq(x, q, s, b, *, act, kernel):
    """The JAX plain gemm_wq, or (``kernel``) the Pallas kernel in
    interpret mode, scope entered inside the jitted function."""
    if not kernel:
        return jref.gemm_wq_ref(x, q, s, bias=b, scale=0.5, act=act)
    with use_backend("interpret"):
        return jops.gemm_wq(x, q, s, b, scale=0.5, act=act)


@functools.partial(jax.jit, static_argnames=("cap", "kernel"),
                   compiler_options=FAST_COMPILE)
def _jpaged(*args, cap, kernel):
    """The JAX plain paged_attention, or (``kernel``) _pa_kernel_quant in
    interpret mode."""
    if not kernel:
        return jref.paged_attention_ref(*args, cap=cap)
    with use_backend("interpret"):
        return jops.paged_attention(*args, cap=cap)


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _bits(t) -> np.ndarray:
    """Codes or scales as raw integers (fp8 and fp16 by their bits)."""
    if isinstance(t, torch.Tensor):
        size = t.element_size()
        t = t.view({1: torch.uint8, 2: torch.int16}.get(size, t.dtype))
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _jax_codes(q: torch.Tensor, dtype: str):
    """The port's codes as a JAX array of the reference's storage dtype
    (the quantizers agree bit for bit: test_quantize_weight_bit_exact)."""
    return jnp.asarray(_bits(q)).view(jquant.tensor._storage_dtype(dtype))


def _quant_cfgs(weight_dtype, kv_dtype="", block=32):
    kw = dict(weight_dtype=weight_dtype, kv_dtype=kv_dtype,
              quant_block=block)
    return (jreduced(jget_arch("qwen3-0.6b")).replace(**SMALL, **kw),
            reduced(get_arch("qwen3-0.6b")).replace(**SMALL, **kw))


class _Model:
    """The SMALL model's reference params, the port's copy, and both
    packages' quantized trees per weight dtype (quant_block 32), made once.
    The reference's ``init`` and ``quantize_params`` run under ``jax.jit``
    here, which compiles once instead of op by op;
    ``test_params_bytes_and_converter`` holds the quantized tree bit for
    bit to the port's quantizer."""

    def __init__(self):
        jcfg, cfg = _quant_cfgs("")
        self.jparams = jax.jit(jinit, static_argnums=1,
                               compiler_options=FAST_COMPILE)(
            jax.random.PRNGKey(0), jcfg)
        self.params = convert_params(jax.tree.map(np.asarray, self.jparams),
                                     cfg, device="cpu")
        self._trees = {}

    def quantized(self, dtype):
        if dtype not in self._trees:
            jcfg, cfg = _quant_cfgs(dtype)
            jq = jax.jit(lambda p: jquant.quantize_params(p, jcfg),
                         compiler_options=FAST_COMPILE)(self.jparams)
            self._trees[dtype] = (jq, quant.quantize_params(self.params,
                                                            cfg))
        return self._trees[dtype]


@pytest.fixture(scope="module")
def model():
    return _Model()


# --------------------------------------------------------------------------
# the quantizer, bit for bit
# --------------------------------------------------------------------------
def _weights() -> np.ndarray:
    """Normal values, with all-zero and outlier rows, columns and blocks
    apart from each other, so that each scale sees one of the three."""
    w = np.random.default_rng(0).standard_normal((64, 48)).astype(np.float32)
    w[:, 7] = 0.0                # a zero column, a zero block, a zero row
    w[:32, 5] = 0.0
    w[11] = 0.0
    # values past fp8's largest finite 448
    w[3, 2], w[40, 9], w[10, 10], w[0, 47] = 1e3, -5e3, 600.0, -449.0
    return w


#: the reference quantizer and its inverse compiled whole, once per
#: configuration, rather than op by op (the same XLA ops either way)
@functools.partial(jax.jit, static_argnames=("dtype", "block", "axis"),
                   compiler_options=FAST_COMPILE)
def _jquantize_weight(w, dtype, block, axis):
    q, s = jquant.quantize_weight(w, dtype, block=block, axis=axis)
    pack = 2 if dtype == "int4" else 1
    return q, s, jquant.dequantize_weight(q, s, axis=axis, pack=pack)


@functools.partial(jax.jit, static_argnames="dtype",
                   compiler_options=FAST_COMPILE)
def _jquantize_kv(x, dtype):
    q, s = jquant.quantize_kv(x, dtype)
    return q, s, jquant.dequantize_kv(q, s)


@pytest.mark.parametrize("block,axis", [(0, -2), (32, -2), (0, -1)])
@pytest.mark.parametrize("dtype", ["int8", "fp8", "int4"])
def test_quantize_weight_bit_exact(dtype, block, axis):
    w = _weights()
    q, s = quant.quantize_weight(torch.from_numpy(w), dtype, block=block,
                                 axis=axis)
    jq, js, jw = _jquantize_weight(jnp.asarray(w), dtype, block=block,
                                   axis=axis)
    assert q.shape == jq.shape and s.dtype == torch.float16
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    np.testing.assert_array_equal(_bits(s), _bits(js))
    pack = 2 if dtype == "int4" else 1
    np.testing.assert_array_equal(
        quant.dequantize_weight(q, s, axis=axis, pack=pack).numpy(), _np(jw))
    assert np.isfinite(quant.dequantize_weight(q, s, axis=axis,
                                               pack=pack).numpy()).all()


def test_dtype_names_and_bytes_match_jax():
    for name in ("int8", "fp8", "e4m3", "float8", "float8_e4m3fn", "int4",
                 "bfloat16", "float32"):
        assert quant.tensor.dtype_bytes(name) == jquant.tensor.dtype_bytes(
            name), name
        assert quant.is_quant_dtype(name) == jquant.is_quant_dtype(name)
    assert quant.canonical_dtype("fp8") == jquant.canonical_dtype("fp8")
    with pytest.raises(ValueError, match="unknown quant dtype"):
        quant.canonical_dtype("int2")


@pytest.mark.parametrize("axis", [-1, -2])
def test_pack_unpack_int4_match_jax(axis):
    codes = np.random.default_rng(1).integers(-7, 8, (3, 8, 10)).astype(
        np.int8)
    packed = quant.pack_int4(torch.from_numpy(codes), axis)
    jpacked = jax.jit(jquant.pack_int4, static_argnums=1)(
        jnp.asarray(codes), axis)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(quant.unpack_int4(packed, axis).numpy(),
                                  codes)
    with pytest.raises(ValueError, match="even"):
        quant.pack_int4(torch.zeros(3, 5, dtype=torch.int8), -1)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_kv_bit_exact(dtype):
    x = np.random.default_rng(2).standard_normal((5, 3, 16)).astype(
        np.float32)
    x[1, 2] = 0.0
    x[4, 0, 3] = 900.0
    q, s = quant.quantize_kv(torch.from_numpy(x), dtype)
    jq, js, jx = _jquantize_kv(jnp.asarray(x), dtype)
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    np.testing.assert_array_equal(_bits(s), _bits(js))
    np.testing.assert_array_equal(quant.dequantize_kv(q, s).numpy(),
                                  _np(jx))
    with pytest.raises(ValueError, match="weight-only"):
        quant.quantize_kv(torch.from_numpy(x), "int4")


# --------------------------------------------------------------------------
# gemm_wq
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,block,act,bias", [
    ("int8", 32, "silu", True), ("fp8", 0, "gelu", False),
    ("int4", 16, None, True)])
def test_gemm_wq_plain_matches_jax(dtype, block, act, bias):
    rng = np.random.default_rng(3)
    M, K, N = 13, 64, 40                 # ragged M and N for the kernels
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.2
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    q, s = quant.quantize_weight(torch.from_numpy(w), dtype, block=block)
    jq, js = _jax_codes(q, dtype), jnp.asarray(s.numpy())
    tb = None if b is None else torch.from_numpy(b)
    jb = None if b is None else jnp.asarray(b)
    got = ops.gemm_wq(torch.from_numpy(x), q, s, tb, scale=0.5, act=act)
    assert got.shape == (M, N) and got.dtype == torch.float32
    jx = jnp.asarray(x)
    want = _jgemm_wq(jx, jq, js, jb, act=act, kernel=False)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=TOL)
    want = _jgemm_wq(jx, jq, js, jb, act=act, kernel=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=TOL)


def test_gemm_wq_validate_and_launch_geometry():
    x = torch.zeros(4, 66)
    codes = torch.zeros(33, 8, dtype=torch.int8)          # packed int4
    assert twq.validate(x, codes, torch.zeros(1, 8, dtype=torch.float16),
                        None, None) == (twq.INT4, 66)
    with pytest.raises(ValueError, match="even quant block"):
        twq.validate(x, codes, torch.zeros(2, 8, dtype=torch.float16),
                     None, None)                           # qb = 33
    with pytest.raises(ValueError, match="nb"):
        twq.validate(torch.zeros(4, 64), torch.zeros(64, 8, dtype=torch.int8),
                     torch.zeros(3, 8, dtype=torch.float16), None, None)
    with pytest.raises(ValueError, match="int8 or float8"):
        twq.validate(torch.zeros(4, 64), torch.zeros(64, 8),
                     torch.zeros(1, 8, dtype=torch.float16), None, None)
    fp8 = torch.zeros(64, 8, dtype=torch.float8_e4m3fn)
    assert twq.validate(torch.zeros(4, 64), fp8, torch.zeros(2, 8,
                        dtype=torch.float16), None, "silu") == (twq.FP8, 32)
    for M, N in ((4, 3072), (64, 1024), (65, 63)):
        gx, gy = twq.launch_geometry(M, N)
        assert (gx - 1) * 64 < N <= gx * 64 and (gy - 1) * 64 < M <= gy * 64
    before = [k.launches for k in ops.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        twq.gemm_wq_cuda(torch.zeros(4, 64), fp8,
                         torch.zeros(2, 8, dtype=torch.float16))
    assert [k.launches for k in ops.KERNELS] == before


# --------------------------------------------------------------------------
# quantized paged_attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,cap", [("int8", 0.0), ("fp8", 4.0)])
def test_paged_attention_quant_plain_matches_jax(dtype, cap):
    rng = np.random.default_rng(5)
    B, K, G, D, page, N, P = 4, 2, 2, 16, 8, 14, 4
    q = rng.standard_normal((B, K, G, D)).astype(np.float32)
    pools = [rng.standard_normal((N, page, K, D)).astype(np.float32) * 2
             for _ in range(2)]
    (kq, ks), (vq, vs) = (quant.quantize_kv(torch.from_numpy(p), dtype)
                          for p in pools)
    tables = np.zeros((B, P), np.int32)
    blocks = rng.permutation(np.arange(1, N))
    lengths = np.array([9, 32, 1, 0], np.int32)  # partial last page, full,
    for b, n in enumerate(lengths):             # one row, an empty slot
        tables[b, :-(-n // page)] = blocks[b * P:b * P + -(-n // page)]
    targs = (torch.from_numpy(q), kq, vq, torch.from_numpy(tables),
             torch.from_numpy(lengths), ks, vs)
    jargs = (jnp.asarray(q), _jax_codes(kq, dtype), _jax_codes(vq, dtype),
             jnp.asarray(tables), jnp.asarray(lengths),
             jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()))
    got = ops.paged_attention(*targs, cap=cap)
    assert got.shape == (B, K, G, D) and got.dtype == torch.float32
    live = lengths > 0
    want = _np(_jpaged(*jargs, cap=cap, kernel=False))
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=TOL,
                               rtol=TOL)
    assert not got[~torch.from_numpy(live)].any()
    want = _jpaged(*jargs, cap=cap, kernel=True)   # _pa_kernel_quant
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="k_scale"):
        ops.paged_attention(*targs[:5])


# --------------------------------------------------------------------------
# parameters, sizes and the converter
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int8", "fp8", "int4"])
def test_params_bytes_and_converter_match_jax(model, dtype):
    jparams, params = model.jparams, model.params
    _, cfg = _quant_cfgs(dtype)
    jq, mine = model.quantized(dtype)
    assert quant.is_quantized(mine) and not quant.is_quantized(params)
    assert quant.param_bytes(mine) == jquant.param_bytes(jq)
    assert quant.param_bytes(params) == jquant.param_bytes(
        jax.tree.map(lambda a: a.astype(jnp.float32), jparams))
    assert quant.quantize_params(mine, cfg)["embed"] is mine["embed"]
    converted = convert_params(jax.tree.map(np.asarray, jq), cfg,
                               device="cpu")
    flat = lambda p: {**{k: v for k, v in p.items() if k != "blocks"},
                      **{"blocks." + k: v for k, v in p["blocks"].items()}}
    a, b = flat(mine), flat(converted)
    assert a.keys() == b.keys()
    for name in a:
        if isinstance(a[name], quant.QuantTensor):
            assert (b[name].axis, b[name].pack) == (a[name].axis,
                                                    a[name].pack), name
            np.testing.assert_array_equal(_bits(b[name].q), _bits(a[name].q))
            np.testing.assert_array_equal(_bits(b[name].scales),
                                          _bits(a[name].scales))
        else:
            torch.testing.assert_close(b[name], a[name], atol=0, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["", "int8", "fp8"])
def test_kv_sizing_matches_jax(kv_dtype):
    jcfg, cfg = _quant_cfgs("", kv_dtype)
    assert kv_block_bytes(cfg, 8) == jkv_block_bytes(jcfg, 8)
    for budget in (0, 10_000, 1 << 20):
        assert (n_blocks_for_bytes(cfg, budget, 8)
                == jn_blocks_for_bytes(jcfg, budget, 8))
    cache = init_cache(cfg, 5, 8, torch.device("cpu"))
    assert sum(t.numel() * t.element_size() for t in cache.values()) \
        == 5 * kv_block_bytes(cfg, 8)


# --------------------------------------------------------------------------
# the model and the served rungs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int8", "fp8", "int4"])
def test_quantized_logits_match_jax_forward(model, dtype):
    jcfg, cfg = _quant_cfgs(dtype)
    toks = np.random.default_rng(6).integers(0, 256, (2, 9)).astype(np.int32)
    jq, mine = model.quantized(dtype)
    want = jax.jit(lambda p, t: jlogits_fn(p, jcfg, jforward(p, jcfg, t)[0]),
                   compiler_options=FAST_COMPILE)(jq, jnp.asarray(toks))
    got = logits_fn(mine, cfg, forward(mine, cfg,
                                       torch.from_numpy(toks).long()))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


ENGINE = dict(max_slots=3, max_len=32, page_size=8, prefill_chunk=6,
              device="cpu")
#: served tokens vs the JAX paged path: within MARGIN of its best logit,
#: and its argmax wherever its top-1/top-2 gap exceeds MARGIN. Float noise
#: alone moves logits by ~1e-6 (ATOL), but the engine batches its decode
#: steps, so its K/V rows carry other float noise than either B=1 replay,
#: and a KV code of its pools may round the other way (see the module
#: docstring). One code step moves a stored element by 1/127 of its row's
#: absmax (int8) or by at most 1/8 of itself (fp8); MARGIN = 0.05, fifty
#: times the float32 logit tolerance, allows for such a step. At least
#: three quarters of the steps must be decided by more than MARGIN, so the
#: gate is not vacuous.
MARGIN = 0.05
_jextend = jax.jit(jextend_step, static_argnums=1)
_jdecode = jax.jit(jdecode_step, static_argnums=1)


def _requests(n, seed, lo=3, hi=14, new_lo=2, new_hi=7):
    """``test_torch_serve.py``'s trace."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 256, rng.integers(lo, hi)),
                    max_new_tokens=int(rng.integers(new_lo, new_hi)))
            for i in range(n)]


def _code_steps(mine: torch.Tensor, ref) -> np.ndarray:
    """Per-code distance in code steps: int8 codes by value, fp8 codes by
    their position among the e4m3 values (the bytes of one sign are
    ordered)."""
    a, b = _bits(mine).astype(np.int32), _bits(ref).astype(np.int32)
    if mine.dtype == torch.float8_e4m3fn:
        sign = lambda c: np.where(c & 0x80, -(c & 0x7F), c & 0x7F)
        a, b = sign(a), sign(b)
    return np.abs(a - b)


def _replay(jparams, params, jcfg, cfg, req, tokens):
    """One request alone, as the engine served it: ``extend_step`` over the
    prompt in chunks of ``prefill_chunk``, then ``decode_step`` fed the
    served tokens, in both packages. Returns the reference logits before
    each served token, the port's, and, for each of those rows, the code
    distances of every K/V row written until then."""
    page, chunk = ENGINE["page_size"], ENGINE["prefill_chunk"]
    P = ENGINE["max_len"] // page
    tables = np.arange(1, P + 1, dtype=np.int32)[None]
    jcache = jinit_cache(jcfg, 1, ENGINE["max_len"], n_blocks=P + 1,
                         page_size=page)
    cache = init_cache(cfg, P + 1, page, torch.device("cpu"))
    ttab = torch.from_numpy(tables)
    prompt = np.asarray(req.prompt, np.int32)
    ref_rows, rows, apart = [], [], []
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim

    def codes_apart(n):
        """Code distances of the first n rows of both pools."""
        jpool = jcache["blocks"][0]["self"]
        return np.concatenate([_code_steps(
            cache[name][:, 1:].reshape(L, -1, K, hd)[:, :n],
            np.asarray(jpool[name])[:, 1:].reshape(L, -1, K, hd)[:, :n]
        ).ravel() for name in ("k", "v")])

    for off in range(0, len(prompt), chunk):
        t = min(chunk, len(prompt) - off)
        buf = np.zeros((1, chunk), np.int32)
        buf[0, :t] = prompt[off:off + t]
        want, jcache = _jextend(jparams, jcfg, jcache, jnp.asarray(buf),
                                jnp.int32(off), jnp.int32(t), jnp.int32(0),
                                block_tables=jnp.asarray(tables))
        got = extend_step(params, cfg, cache,
                          torch.from_numpy(buf[:, :t]).long(), off, 0, ttab)
    ref_rows.append(_np(want)[0, 0])
    rows.append(got.numpy()[0, 0])
    apart.append(codes_apart(len(prompt)))
    for i, tok in enumerate(tokens[:-1]):
        pos = len(prompt) + i
        want, jcache = _jdecode(jparams, jcfg, jcache,
                                jnp.asarray([[tok]], jnp.int32),
                                jnp.asarray([pos], jnp.int32),
                                active=jnp.ones(1, bool),
                                block_tables=jnp.asarray(tables))
        got = decode_step(params, cfg, cache, torch.tensor([[tok]]),
                          torch.tensor([pos]), ttab)
        ref_rows.append(_np(want)[0, 0])
        rows.append(got.numpy()[0, 0])
        apart.append(codes_apart(pos + 1))
    return np.stack(ref_rows), np.stack(rows), apart


@pytest.mark.parametrize("weight_dtype,kv_dtype", RUNGS)
def test_quantized_serving_holds_to_the_jax_paged_path(model, weight_dtype,
                                                       kv_dtype):
    jcfg, cfg = _quant_cfgs(weight_dtype, kv_dtype)
    jq, _ = model.quantized(weight_dtype)
    reqs = _requests(6, seed=0)
    # the engine quantizes dense weights itself and takes quantized ones
    # as they are
    given = model.params if weight_dtype == "int8" else model.quantized(
        weight_dtype)[1]
    engine = ServeEngine(cfg, given, **ENGINE)
    assert engine.cache["k"].dtype == quant.tensor.storage_dtype(kv_dtype)
    assert engine.param_bytes == jquant.param_bytes(jq)
    results = engine.run(reqs)
    n_codes = n_apart = gated = total = 0
    for req, res in zip(reqs, results):
        assert res.finish_reason == "length"
        assert len(res.tokens) == req.max_new_tokens == res.decode_steps + 1
        ref, mine, steps = _replay(jq, engine.params, jcfg, cfg, req,
                                   res.tokens)
        n_codes += steps[-1].size
        n_apart += int((steps[-1] > 0).sum())
        assert max(s.max() for s in steps) <= 1, req.uid
        exact = [i for i, s in enumerate(steps) if not s.any()]
        # model logits agree while the pools agree code for code
        np.testing.assert_allclose(mine[exact], ref[exact], atol=ATOL)
        for i, (row, tok) in enumerate(zip(ref, res.tokens)):
            top2 = np.sort(row)[-2:]
            assert row[tok] >= top2[1] - MARGIN, (req.uid, i)
            if top2[1] - top2[0] > MARGIN:
                assert tok == int(row.argmax()), (req.uid, i)
                gated += 1
            total += 1
    assert n_apart <= 1e-3 * n_codes, (n_apart, n_codes)
    assert 4 * gated >= 3 * total, (gated, total)
    assert engine.allocator.n_free == engine.allocator.capacity
    assert not engine.phase.any() and not engine.block_tables.any()
