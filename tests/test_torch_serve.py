"""The port's serving engine (``repro_torch.serve``) against the JAX
package's model-level greedy reference.

The port serves a mixed trace of 6 requests (prompts of 3-13 tokens, 2-6
new tokens, 3 slots, pages of 8, prefill chunks of 6) on the CPU. The
reference is ``forward`` then ``decode_step`` of ``repro.models``, as
``tests/test_serve.py::_ref_greedy`` runs them, but teacher-forced on the
port's own tokens, so one near-tie decided differently cannot cascade into
the following steps. At every step the port's token must be within MARGIN
of the reference's best logit, and must equal the reference's argmax
wherever the reference's top-1/top-2 gap exceeds MARGIN. MARGIN = 1e-3 is
ten times the float32 logit tolerance of ``test_torch_model.py`` (1e-4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init as jinit
from repro.models import logits_fn as jlogits_fn
from repro.models.cache import init_cache as jinit_cache
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import convert_params
from repro_torch.serve import Request, ServeEngine

MARGIN = 1e-3
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256, dtype="float32")
ENGINE = dict(max_slots=3, max_len=32, page_size=8, prefill_chunk=6,
              device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_arch("qwen3-0.6b")).replace(**SMALL)
    cfg = reduced(get_arch("qwen3-0.6b")).replace(**SMALL)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, cfg, jparams, params


def _requests(n, seed, lo=3, hi=14, new_lo=2, new_hi=7):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 256, rng.integers(lo, hi)),
                    max_new_tokens=int(rng.integers(new_lo, new_hi)))
            for i in range(n)]


_jdecode = jax.jit(jdecode_step, static_argnums=1)


def _reference_logits(jcfg, jparams, prompt, tokens):
    """Reference logits before each served token, teacher-forced on the
    served tokens: row i scores the token at position len(prompt) + i."""
    cache = jinit_cache(jcfg, 1, ENGINE["max_len"])
    hidden, cache, _ = jforward(jparams, jcfg,
                                jnp.asarray(prompt, jnp.int32)[None],
                                cache=cache)
    rows = [jlogits_fn(jparams, jcfg, hidden[:, -1:])[0, 0]]
    for i, tok in enumerate(tokens[:-1]):
        lg, cache = _jdecode(jparams, jcfg, cache,
                                 jnp.asarray([[tok]], jnp.int32),
                                 jnp.asarray(len(prompt) + i, jnp.int32))
        rows.append(lg[0, 0])
    return np.asarray(jnp.stack(rows), np.float32)


def _assert_leak_free(engine):
    assert engine.allocator.n_free == engine.allocator.capacity
    assert not engine.phase.any() and not engine.block_tables.any()
    assert not engine._tables.any()


def test_served_tokens_hold_to_the_jax_reference(model):
    jcfg, cfg, jparams, params = model
    reqs = _requests(6, seed=0)
    engine = ServeEngine(cfg, params, **ENGINE)
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


def test_small_pool_waits_in_order_and_drains(model):
    """A pool of 5 blocks holds two requests at a time: the third waits at
    the head of the queue (first come, first served) and the drain leaves
    every block free."""
    _, cfg, _, params = model
    reqs = _requests(5, seed=1, lo=9, hi=14, new_lo=4, new_hi=7)
    engine = ServeEngine(cfg, params, **{**ENGINE, "max_blocks": 5})
    admitted = []
    for r in reqs:
        engine.submit(r)
    while engine.queue or engine.phase.any():
        engine.step()
        admitted += [r.uid for r in engine._slot_req
                     if r is not None and r.uid not in admitted]
    assert admitted == [r.uid for r in reqs]
    assert all(len(engine.results[r.uid].tokens) == r.max_new_tokens
               for r in reqs)
    _assert_leak_free(engine)


def test_eos_and_rejection(model):
    _, cfg, _, params = model
    reqs = _requests(2, seed=2)
    [probe] = ServeEngine(cfg, params, **ENGINE).run(reqs[:1])
    engine = ServeEngine(cfg, params, eos_id=probe.tokens[0], **ENGINE)
    too_long = Request(uid=9, prompt=np.zeros(30, np.int64),
                       max_new_tokens=8)
    off_vocab = Request(uid=10, prompt=np.array([3, 256]), max_new_tokens=2)
    eos, bad, bad_id, ok = engine.run([reqs[0], too_long, off_vocab, reqs[1]])
    assert eos.finish_reason == "eos" and eos.tokens == probe.tokens[:1]
    for r in (bad, bad_id):
        assert r.finish_reason == "rejected" and not r.tokens
    assert ok.finish_reason in ("eos", "length") and ok.tokens
    _assert_leak_free(engine)


def test_engine_defaults_to_the_card(model):
    _, cfg, _, params = model
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params)
