#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. print the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc/``, one
   ``nvcc`` each, all started together, and print their registers, spills
   and shared memory;
3. hold each kernel against its plain PyTorch version at the full-width
   shapes of qwen3-0.6b's serving path, and time kernel, plain version and,
   where one PyTorch call computes the same function, that call. Every
   timed call starts with a cold L2 cache: a 512 MiB buffer is rewritten
   before it, as each layer's weights and KV pages are cold on the path.
   That write also keeps the device busy while the host enqueues the
   timed call, so the CUDA events time the device, not the host's launch
   path;
4. serve 8 requests of full-width qwen3-0.6b (28 layers, random bf16
   weights from a seeded ``torch.Generator``) through ``ServeEngine``:
   prompts of 40-200 tokens, 16 new tokens each, 4 slots, pages of 16,
   prefill chunks of 64. Kernel launch counts are set to 0 just before and
   read just after: ``gemm`` and ``paged_attention`` must have run;
5. run ``forward`` on each prompt with its served tokens appended
   (teacher forcing), counted the same way: ``flash_attention`` must have
   run, and every served token must hold to forward's logits by the margin
   rule below;
6. profile one more serving run (device time by kernel, device busy share);
7. print the ``kernels`` JSON line, then the result line.

Exits non-zero, printing no result, when ``torch.cuda.is_available()`` is
false or when the repository's ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
#: kernel vs plain version, elementwise |got - want| <= ATOL + RTOL * |want|:
#: bf16 outputs round at ~0.4% and the two sum in different orders
ATOL = RTOL = 2e-2
#: teacher forcing in bf16: the served token's forward logit must be within
#: MARGIN of forward's best, and equal the argmax where forward's top-1/top-2
#: gap exceeds MARGIN. Paged decode and the whole-sequence forward round
#: bf16 activations at different points through 28 layers, and bf16 logits
#: near 4 are 0.03 apart, so near-ties may fall either way.
MARGIN = 0.1
SEED = 0


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import forward, init, logits_fn
    from repro_torch.serve import Request, ServeEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all(ops.KERNELS)
    print(f"[build] {len(ops.KERNELS)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for k in ops.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {k.name}: {line.strip()}")

    # ---- 3. kernels against their plain versions -----------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)

    def bf16(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).bfloat16()

    def cold_ms(fn, reps=30):
        """Mean device time of ``fn`` over ``reps`` calls, each started
        with a cold L2 (CUDA events around each call alone)."""
        fn()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in pairs:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps

    def compare(name, got, want):
        err = (got.float() - want.float()).abs()
        ok = bool((err <= ATOL + RTOL * want.float().abs()).all())
        require(bool(torch.isfinite(got.float()).all()) and ok,
                f"{name}: kernel disagrees with its plain version "
                f"(max_abs_err {err.max().item():.3e})")
        return err.max().item()

    def bound(n_bytes, n_flops):
        t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
        t_ops = n_flops / BF16_FLOP_PER_S * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))

    entries = {}
    cfg = get_arch("qwen3-0.6b")
    d, f_ = cfg.d_model, cfg.d_ff
    for M in (4, 64):        # live slots at decode, chunk length at prefill
        for proj, K, N, act in (("gate", d, f_, "silu"), ("up", d, f_, None),
                                ("down", f_, d, None)):
            x, w = bf16(M, K), bf16(K, N, scale=K ** -0.5)
            got = gm.gemm_cuda(x, w, act=act)
            err = compare(f"gemm {proj} M={M}", got,
                          ref.gemm_ref(x, w, act=act))
            ms = cold_ms(lambda: gm.gemm_cuda(x, w, act=act))
            plain_ms = cold_ms(lambda: ref.gemm_ref(x, w, act=act))
            lib_ms = (cold_ms(lambda: torch.matmul(x, w)) if act is None
                      else None)
            b_ms, b_by = bound(2 * (M * K + K * N + M * N), 2 * M * N * K)
            print(f"[kernel] gemm {proj} M={M} {K}->{N} act={act}: "
                  f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}"
                  f" library_ms={lib_ms} bound_ms={b_ms:.4f} ({b_by})")
            if M == 4 and proj == "up":
                entries["gemm"] = dict(
                    shape=f"M={M} K={K} N={N} act=None bf16", ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, max_abs_err=err)

    B, Kh, G, D, page, P = 4, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim, 16, 16
    n_blocks = B * P + 1
    lengths_l = [41, 100, 172, 216]
    q = bf16(B, Kh, G, D)
    kp, vp = bf16(n_blocks, page, Kh, D), bf16(n_blocks, page, Kh, D)
    tables = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1)
    tables = tables.reshape(B, P).to(torch.int32).contiguous()
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    args = (q, kp, vp, tables, lengths)
    err = compare("paged_attention", pa.paged_attention_cuda(*args),
                  ref.paged_attention_ref(*args))
    ms = cold_ms(lambda: pa.paged_attention_cuda(*args))
    plain_ms = cold_ms(lambda: ref.paged_attention_ref(*args))
    rows = sum(lengths_l)
    n_pages = sum(pa.pages_to_read(n, page) for n in lengths_l)
    b_ms, b_by = bound(2 * 2 * q.numel() + 2 * 2 * rows * Kh * D
                       + 4 * (n_pages + B), 4 * rows * Kh * G * D)
    print(f"[kernel] paged_attention B={B} K={Kh} G={G} D={D} page={page} "
          f"lengths={lengths_l}: max_abs_err={err:.3e} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms=None bound_ms={b_ms:.4f} "
          f"({b_by})")
    entries["paged_attention"] = dict(
        shape=f"B={B} K={Kh} G={G} D={D} page={page} lengths={lengths_l} "
              "bf16", ms=ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)

    BH, BK = cfg.n_heads, cfg.n_kv_heads
    for S in (64, 215):
        q, k, v = bf16(BH, S, D), bf16(BK, S, D), bf16(BK, S, D)
        err = compare(f"flash_attention S={S}",
                      fa.flash_attention_cuda(q, k, v),
                      ref.flash_attention_ref(q, k, v))
        ms = cold_ms(lambda: fa.flash_attention_cuda(q, k, v))
        plain_ms = cold_ms(lambda: ref.flash_attention_ref(q, k, v))
        lib_ms = cold_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, enable_gqa=True))
        b_ms, b_by = bound(2 * 2 * (BH + BK) * S * D,
                           4 * BH * D * S * (S + 1) // 2)
        print(f"[kernel] flash_attention BH={BH} BK={BK} S={S} D={D} causal: "
              f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        entries["flash_attention"] = dict(
            shape=f"BH={BH} BK={BK} S={S} D={D} causal bf16", ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by, max_abs_err=err)
    del flush

    # ---- 4. serve full-width qwen3-0.6b --------------------------------
    t0 = time.perf_counter()
    params = init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {d}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {D}, d_ff {f_}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e6:.1f} M params, bf16 "
          f"{2 * n_params / 1e9:.2f} GB, drawn from torch.Generator seed "
          f"{SEED} in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                int(rng.integers(40, 201))),
                    max_new_tokens=16) for i in range(8)]
    engine_kw = dict(max_slots=4, max_len=256, page_size=16,
                     prefill_chunk=64, device="cuda")
    ServeEngine(cfg, params, **engine_kw).run(reqs[:2])   # warm-up
    engine = ServeEngine(cfg, params, **engine_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_counts = {k.name: k.launches for k in ops.KERNELS}
    steps, chunks = engine.stats["decode_steps"], engine.stats["prefill_chunks"]
    for req, res in zip(reqs, results):
        require(res.finish_reason == "length" and len(res.tokens) == 16
                and all(0 <= t < cfg.vocab_size for t in res.tokens),
                f"request {req.uid}: {res.finish_reason}, {res.tokens}")
    require(engine.allocator.n_free == engine.allocator.capacity,
            "blocks leaked after the drain")
    L = cfg.n_layers
    require(serve_counts == {"gemm": 3 * L * (steps + chunks),
                             "paged_attention": L * steps,
                             "flash_attention": 0},
            f"launches while serving {serve_counts} do not match "
            f"{steps} decode steps and {chunks} prefill chunks")
    n_new = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s * 1e3 for r in results]
    print(f"[serve] 8 requests on 4 slots, prompts "
          f"{[len(r.prompt) for r in reqs]}, 16 new tokens each, page 16, "
          f"chunk 64: {n_new} tokens in {wall:.3f} s = {n_new / wall:.1f} "
          f"tok/s; TTFT mean {np.mean(ttft):.1f} ms, max {max(ttft):.1f} "
          f"ms; {steps} decode steps, {chunks} prefill chunks; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"[serve] launches while serving {serve_counts} (per decode step: "
          f"gemm {3 * L}, paged_attention {L}; per prefill chunk: gemm "
          f"{3 * L})")

    # ---- 5. forward, teacher-forced on the served tokens ---------------
    for k in ops.KERNELS:
        k.launches = 0
    worst, exact, gated = 0.0, 0, 0
    fwd_ms = []
    for req, res in zip(reqs, results):
        seq = np.concatenate([req.prompt, res.tokens[:-1]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = logits_fn(params, cfg, forward(
            params, cfg, torch.as_tensor(seq, device=dev)[None]))
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        lg = lg[0, len(req.prompt) - 1:]
        require(lg.shape == (16, cfg.vocab_size)
                and bool(torch.isfinite(lg).all()), "forward logits")
        top2 = lg.topk(2, dim=-1).values
        served = torch.as_tensor(res.tokens, device=dev)
        gap = top2[:, 0] - lg.gather(1, served[:, None])[:, 0]
        worst = max(worst, gap.max().item())
        decided = (top2[:, 0] - top2[:, 1]) > MARGIN
        require(bool((gap <= MARGIN).all()), f"request {req.uid}: a served "
                f"token is {gap.max().item():.4f} below forward's best")
        require(bool((gap[decided] == 0).all()), f"request {req.uid}: "
                "served token differs from forward's clear argmax")
        exact += int((gap == 0).sum())
        gated += int(decided.sum())
    fwd_counts = {k.name: k.launches for k in ops.KERNELS}
    require(fwd_counts == {"gemm": 3 * L * 8, "paged_attention": 0,
                           "flash_attention": L * 8},
            f"launches in the 8 forward passes {fwd_counts}")
    lens = [len(r.prompt) + 15 for r in reqs]
    print(f"[forward] 8 teacher-forced passes of {min(lens)}-{max(lens)} "
          f"tokens, mean "
          f"{np.mean(fwd_ms):.1f} ms each; launches {fwd_counts} (per "
          f"forward: gemm {3 * L}, flash_attention {L})")
    print(f"[forward] served tokens vs forward: exact argmax {exact}/{n_new}, "
          f"{gated} steps with a top-1/top-2 gap > {MARGIN} all equal, worst "
          f"gap to the top logit {worst:.4f} (margin {MARGIN})")

    # ---- 6. where the device time goes while serving -------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = ServeEngine(cfg, params, **engine_kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(t for t, _, _ in by_kernel) / 1e3
    print(f"[profile] serving run under the profiler: wall {wall * 1e3:.1f} "
          f"ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / (wall * 1e3):.1f}%)")
    for t, n, key in by_kernel[:10]:
        print(f"[profile] {t / 1e3:9.2f} ms {n:6d} x {key[:90]}")

    # ---- 7. summary lines ----------------------------------------------
    kernels = []
    root = Path(__file__).resolve().parent
    for k in ops.KERNELS:
        e = entries[k.name]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": str(k.source.relative_to(root)),
            "replaces": k.replaces,
            "launches": serve_counts[k.name] + fwd_counts[k.name],
            "launches_by_path": {"serve": serve_counts[k.name],
                                 "forward": fwd_counts[k.name]},
            "shape": e["shape"], "max_abs_err": e["max_abs_err"],
            "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": e["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
