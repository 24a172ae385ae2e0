#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile-rungs]

Phases, each fatal on failure (nothing is caught):

1. print the card's name and power limit (``nvidia-smi``);
2. build the seven CUDA kernels from ``src/repro_torch/kernels/csrc/``, one
   ``nvcc`` each, all started together, and print their registers, spills
   and shared memory;
3. hold each kernel against its plain PyTorch version at the full-width
   shapes of qwen3-0.6b's serving path (``lru_scan`` at falcon-mamba-7b's:
   an ``extend_step`` chunk of 64 and a ``forward`` of 215 tokens over
   D = 8192 * 16 channels, and a ragged shape; ``packed_gather_rows``
   bit-exact at qwen2-moe-a2.7b's decode and prefill-chunk token streams
   and a ragged float32 shape), and time kernel, plain
   version and, where one PyTorch call computes the same function, that
   call. Every
   timed call starts with a cold L2 cache: a 512 MiB buffer is rewritten
   before it, as each layer's weights and KV pages are cold on the path.
   That write also keeps the device busy while the host enqueues the
   timed call, so the CUDA events time the device, not the host's launch
   path. ``gemm_wq`` runs int8, fp8 and int4 codes with quant blocks of 32
   (and int8 per channel once), the quantized ``paged_attention`` int8 and
   fp8 pools;
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
7. serve the same trace on the two quantized rungs, int8 weights with int8
   KV and int4 weights with fp8 KV (quant blocks of 32), counted the same
   way: only ``gemm_wq`` and ``paged_attention_quant`` may have run, 84 and
   28 per decode step. Each served token must hold, by the same margin
   rule, to the rung's own model-level path run for its request alone
   (``extend_step`` in the same chunks, then ``decode_step``). With
   ``--profile-rungs`` each rung is also profiled as in phase 6 (off by
   default: the profiled runs would take most of the script's time).
   Agreement with the bf16 model (its argmax on the rung's tokens, and the
   cosine similarity of the two models' logits) is reported, not gated:
   random weights have near-tied logits;
8. free qwen3-0.6b's weights, then serve the same kind of trace (8
   requests, prompts of 40-200 tokens, 16 new tokens, 4 slots, prefill
   chunks of 64) with full-width falcon-mamba-7b (64 Mamba-1 layers,
   d_model 4096, vocab 65024, random bf16 weights from a seeded
   ``torch.Generator``), counted the same way: only ``lru_scan`` may have
   run, 64 times per prefill chunk. Then ``forward`` on each prompt with
   its served tokens appended, 64 ``lru_scan`` launches per call. The same
   weights are then served and run through ``forward`` in float32, counted
   the same way (with ``--profile-rungs`` each serving run is profiled as
   in phase 6). Gates: in float32 every served token holds to forward's
   logits by the margin rule. In bf16 every served token holds by the same
   rule to its request replayed alone through ``extend_step`` (chunks of
   64) and ``decode_step``; and bf16 forward, that replay and float32
   forward of the same weights on the bf16 tokens (the witness) must agree
   within ``BF16_LOGIT_TOL``. The margin rule against bf16 forward is
   reported, not gated: the two bf16 paths round at different points and
   64 layers carry that to logit differences of up to ~0.3, over the
   margin, while in float32 the two agree to ~1e-4;
9. free falcon-mamba-7b's weights, then serve the same kind of trace with
   full-width qwen2-moe-a2.7b (24 layers of full attention and a MoE MLP:
   60 experts of width 1408, top 4, a gated shared expert of width 5632;
   random bf16 weights from a seeded ``torch.Generator``), counted the same
   way: ``packed_gather_rows`` and ``gemm`` must have run 24 and 72 times
   per prefill chunk and decode step, ``paged_attention`` 24 times per
   decode step, and nothing else. Expert capacity depends on which rows
   route together, so the gates are: every served token holds by the
   margin rule to the engine's recorded steps replayed through
   ``extend_step`` / ``decode_step`` with the same row sets; and layer 0's
   ``moe_forward`` at a decode (4 rows) and a chunk (64 tokens) shape
   routes exactly as ``moe_oracle``, a float32 oracle that keeps each
   expert's first C tokens by counting, drops assignments, and lies within
   ``MOE_ATOL + MOE_RTOL * |want|`` of it. ``forward`` on each prompt with
   its served tokens appended is counted (``flash_attention`` 24 per call)
   and must give finite logits; its argmax is reported, not gated;
10. print the ``kernels`` JSON line, then the result line.

Exits non-zero, printing no result, when ``torch.cuda.is_available()`` is
false or when the repository's ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
#: kernel vs plain version, elementwise |got - want| <= ATOL + RTOL * |want|:
#: bf16 outputs round at ~0.4% and the two sum in different orders
ATOL = RTOL = 2e-2
#: lru_scan is float32 and does the plain version's rounded multiply and
#: add per step in the same order
LRU_TOL = 1e-5
#: teacher forcing in bf16: the served token's forward logit must be within
#: MARGIN of forward's best, and equal the argmax where forward's top-1/top-2
#: gap exceeds MARGIN. Paged decode and the whole-sequence forward round
#: bf16 activations at different points through 28 layers, and bf16 logits
#: near 4 are 0.03 apart, so near-ties may fall either way.
MARGIN = 0.1
#: bf16 falcon-mamba-7b: most that bf16 forward, the bf16 serving path and
#: float32 forward of the same weights may differ by in the logits. The
#: bf16 paths round at different points (cuBLAS takes other kernels for 1-4
#: decode rows than for a 64- or 215-row pass) and 64 layers carry that to
#: differences of up to ~0.3 between them; a dtype fault (a float32 leaf
#: cast to bf16, a state kept in bf16) moves them further.
BF16_LOGIT_TOL = 0.5
#: bf16 qwen2-moe-a2.7b, one layer's ``moe_forward`` against the float32
#: oracle ``moe_oracle`` with the same routing, elementwise
#: |got - want| <= MOE_ATOL + MOE_RTOL * |want|: the bf16 layer rounds its
#: input, the experts' hidden activations and outputs, the gate products
#: and the shared expert's, each by up to 2^-9 of values up to ~4, and sums
#: 2048- and 1408-long products in another order than the oracle
MOE_ATOL, MOE_RTOL = 5e-2, 2e-2
SEED = 0


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def moe_oracle(lp: dict, m, x):
    """A plain float32 oracle of one MoE layer, written apart from
    ``models/moe.py``: x (B, S, d) is grouped as the reference groups it
    (one group per batch row when S > 1, one group at decode), each token
    takes its top-k experts of a float32 softmax router, and each expert
    keeps the first C tokens that chose it, counted in token order (no
    sort). Every expert's gated FFN runs in float32 on the tokens it kept,
    weighted by their gates; the sigmoid-gated shared expert (a silu MLP,
    as qwen2-moe-a2.7b's ``act`` is) is added.
    Returns (y (B, S, d) float32, expert indices (G, T, k), keep mask
    (G, T, k))."""
    import math

    import torch
    import torch.nn.functional as F
    B, S, d = x.shape
    G = B if S > 1 else 1
    T = B * S // G
    C = max(1, math.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
    xg = x.float().reshape(G, T, d)
    probs = torch.softmax(xg @ lp["router"].float(), dim=-1)
    gate, idx = probs.topk(m.top_k, dim=-1)
    if m.renorm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.zeros_like(idx, dtype=torch.bool)
    y = torch.zeros_like(xg)
    for g in range(G):
        for e in range(m.n_experts):
            hit = idx[g] == e                          # (T, k)
            taken = 0
            for t in hit.any(-1).nonzero()[:, 0].tolist():
                if taken == C:
                    break
                keep[g, t] |= hit[t]
                taken += 1
            rows = (keep[g] & hit).any(-1)
            if not rows.any():
                continue
            xe = xg[g, rows]
            h = F.silu(xe @ lp["experts_gate"][e].float()) * (
                xe @ lp["experts_up"][e].float())
            w = (gate[g, rows] * hit[rows]).sum(-1, keepdim=True)
            y[g, rows] += w * (h @ lp["experts_down"][e].float())
    xf = x.float().reshape(G, T, d)
    ys = (F.silu(xf @ lp["gate"].float()) * (xf @ lp["up"].float())
          ) @ lp["down"].float()
    if m.shared_gate:
        ys = ys * torch.sigmoid(xf @ lp["shared_gate"].float())
    return (y + ys).reshape(B, S, d), idx, keep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-rungs", action="store_true",
                    help="also profile a serving run of each quantized "
                         "rung and of falcon-mamba-7b")
    profile_rungs = ap.parse_args().profile_rungs
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
    from repro_torch.kernels import gemm_wq as wq
    from repro_torch.kernels import lru_scan as lru
    from repro_torch.kernels import packed_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import (decode_step, extend_step, forward, init,
                                    logits_fn)
    from repro_torch.models import moe
    from repro_torch.models.cache import init_cache
    from repro_torch.quant import quantize_kv, quantize_params, quantize_weight
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

    def compare(name, got, want, tol=ATOL):
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol + tol * want.float().abs()).all())
        require(bool(torch.isfinite(got.float()).all()) and ok,
                f"{name}: kernel disagrees with its plain version "
                f"(max_abs_err {err.max().item():.3e})")
        return err.max().item()

    def bound(n_bytes, n_flops, flop_per_s=BF16_FLOP_PER_S):
        t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
        t_ops = n_flops / flop_per_s * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))

    entries, yardstick = {}, {}
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
            mm_ms = cold_ms(lambda: torch.matmul(x, w))
            lib_ms = mm_ms if act is None else None
            b_ms, b_by = bound(2 * (M * K + K * N + M * N), 2 * M * N * K)
            print(f"[kernel] gemm {proj} M={M} {K}->{N} act={act}: "
                  f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}"
                  f" library_ms={lib_ms} bound_ms={b_ms:.4f} ({b_by})")
            yardstick[(M, proj)] = (ms, mm_ms)
            if M == 4 and proj == "up":
                entries["gemm"] = dict(
                    shape=f"M={M} K={K} N={N} act=None bf16", ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, max_abs_err=err)

    # gemm_wq at the same shapes: int8 / fp8 / int4 codes, quant blocks of
    # 32 as the served rungs use them, and int8 per channel once. No single
    # PyTorch call computes a per-block weight-only product (library_ms
    # null); the bf16 gemm kernel and torch.matmul at the shape are printed
    # beside it as yardsticks.
    for M in (4, 64):
        for proj, K, N, act in (("gate", d, f_, "silu"), ("up", d, f_, None),
                                ("down", f_, d, None)):
            x, w = bf16(M, K), bf16(K, N, scale=K ** -0.5)
            g_ms, mm_ms = yardstick[(M, proj)]
            print(f"[kernel] yardsticks {proj} M={M} {K}->{N}: bf16 gemm "
                  f"kernel ms={g_ms:.4f}, torch.matmul ms={mm_ms:.4f}")
            variants = [("int8", 32), ("fp8", 32), ("int4", 32)]
            if M == 4 and proj == "up":
                variants.append(("int8", 0))
            for dt, qb in variants:
                qw, sc = quantize_weight(w, dt, block=qb)
                name = f"gemm_wq {dt} qb={qb or 'channel'} {proj} M={M}"
                err = compare(name, wq.gemm_wq_cuda(x, qw, sc, act=act),
                              ref.gemm_wq_ref(x, qw, sc, act=act))
                ms = cold_ms(lambda: wq.gemm_wq_cuda(x, qw, sc, act=act))
                plain_ms = cold_ms(lambda: ref.gemm_wq_ref(x, qw, sc,
                                                           act=act))
                b_ms, b_by = bound(2 * M * K + qw.numel() * qw.element_size()
                                   + 2 * sc.numel() + 2 * M * N,
                                   2 * M * N * K)
                print(f"[kernel] {name} {K}->{N} act={act}: "
                      f"max_abs_err={err:.3e} ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} library_ms=None "
                      f"bound_ms={b_ms:.4f} ({b_by})")
                if M == 4 and proj == "up" and (dt, qb) == ("int8", 32):
                    entries["gemm_wq"] = dict(
                        shape=f"M={M} K={K} N={N} act=None int8 qb=32",
                        ms=ms, plain_ms=plain_ms, library_ms=None,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)

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
    for dt in ("int8", "fp8"):     # the same pools, quantized per row
        (kq, ks), (vq, vs) = quantize_kv(kp, dt), quantize_kv(vp, dt)
        args = (q, kq, vq, tables, lengths, ks, vs)
        err = compare(f"paged_attention {dt}",
                      pa.paged_attention_cuda(*args),
                      ref.paged_attention_ref(*args))
        ms = cold_ms(lambda: pa.paged_attention_cuda(*args))
        plain_ms = cold_ms(lambda: ref.paged_attention_ref(*args))
        b_ms, b_by = bound(2 * 2 * q.numel() + 2 * rows * Kh * (D + 2)
                           + 4 * (n_pages + B), 4 * rows * Kh * G * D)
        print(f"[kernel] paged_attention_quant {dt} B={B} K={Kh} G={G} "
              f"D={D} page={page} lengths={lengths_l}: max_abs_err={err:.3e}"
              f" ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None "
              f"bound_ms={b_ms:.4f} ({b_by})")
        if dt == "int8":
            entries["paged_attention_quant"] = dict(
                shape=f"B={B} K={Kh} G={G} D={D} page={page} "
                      f"lengths={lengths_l} int8", ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)

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

    # lru_scan at falcon-mamba-7b's shapes: one extend_step chunk of 64
    # tokens (the serving path) and one forward of 215 tokens, over
    # d_inner * d_state = 8192 * 16 channels; and a ragged shape. a in
    # (0.5, 1) as exp(dt * A) is. No PyTorch call computes the recurrence.
    fm = get_arch("falcon-mamba-7b")
    D_ssm = fm.d_inner * fm.ssm.d_state
    for B_, L_, D_ in ((1, 64, D_ssm), (1, 215, D_ssm), (3, 37, 1000)):
        a = torch.rand((B_, L_, D_), generator=gen, device=dev) * 0.5 + 0.5
        b = torch.randn((B_, L_, D_), generator=gen, device=dev)
        err = compare(f"lru_scan B={B_} L={L_} D={D_}",
                      lru.lru_scan_cuda(a, b), ref.lru_scan_ref(a, b),
                      tol=LRU_TOL)
        ms = cold_ms(lambda: lru.lru_scan_cuda(a, b))
        plain_ms = cold_ms(lambda: ref.lru_scan_ref(a, b), reps=10)
        b_ms, b_by = bound(3 * 4 * a.numel(), 2 * a.numel(), F32_FLOP_PER_S)
        print(f"[kernel] lru_scan B={B_} L={L_} D={D_} float32: "
              f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms=None bound_ms={b_ms:.4f} ({b_by})")
        if (B_, L_) == (1, 64):
            entries["lru_scan"] = dict(
                shape=f"B={B_} L={L_} D={D_} float32", ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)
    # packed_gather_rows at qwen2-moe-a2.7b's token streams: a decode step
    # of 4 rows (T = 4, M = 16) and a prefill chunk (T = 64, M = 256) of
    # d_model 2048 in bf16, each idx the expert-sorted token order that
    # moe._dispatch_sort gathers by; and a ragged float32 shape with
    # unsorted int64 indices. Bit-exact (torch.equal); torch.index_select
    # is the library call. The bound reads each table row that idx names
    # once, the indices once, and writes the output once.
    qm = get_arch("qwen2-moe-a2.7b")
    k_top = qm.moe.top_k
    for N_, D_, M_, dt_ in ((4, qm.d_model, 4 * k_top, torch.bfloat16),
                            (64, qm.d_model, 64 * k_top, torch.bfloat16),
                            (1000, 100, 37, torch.float32)):
        table_ = torch.randn((N_, D_), generator=gen, device=dev).to(dt_)
        if dt_ == torch.bfloat16:
            experts = torch.randint(0, qm.moe.n_experts, (M_,),
                                    generator=gen, device=dev)
            idx_ = torch.argsort(experts, stable=True) // k_top
        else:
            idx_ = torch.randint(0, N_, (M_,), generator=gen, device=dev)
        got = pg.packed_gather_rows_cuda(table_, idx_)
        require(torch.equal(got, ref.gather_rows_ref(table_, idx_)),
                f"packed_gather_rows N={N_} D={D_} M={M_}: not bit-exact")
        ms = cold_ms(lambda: pg.packed_gather_rows_cuda(table_, idx_))
        plain_ms = cold_ms(lambda: ref.gather_rows_ref(table_, idx_))
        lib_ms = cold_ms(lambda: torch.index_select(table_, 0, idx_))
        elt = table_.element_size()
        b_ms, b_by = bound(idx_.unique().numel() * D_ * elt + M_ * 8
                           + M_ * D_ * elt, 0)
        print(f"[kernel] packed_gather_rows N={N_} D={D_} M={M_} {dt_}: "
              f"bit-exact, copy unit "
              f"{pg.copy_unit(D_ * elt, table_.data_ptr(), got.data_ptr())}"
              f" B, ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})")
        if M_ == 64 * k_top:
            entries["packed_gather"] = dict(
                shape=f"N={N_} D={D_} M={M_} bf16 int64", ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0)
    del flush, a, b, table_, idx_, got

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
    L = cfg.n_layers
    n_new = 16 * len(reqs)

    def serve(cfg_x, params_x, label, want, reqs_x=None):
        """Serve the trace (``reqs_x``, default ``reqs``) once after a
        warm-up, launch counts set to 0 just before and read just after;
        ``want(steps, chunks)`` gives the counts the path must show."""
        reqs_x = reqs_x or reqs
        ServeEngine(cfg_x, params_x, **engine_kw).run(reqs_x[:2])  # warm-up
        engine = ServeEngine(cfg_x, params_x, **engine_kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in ops.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        results = engine.run(reqs_x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in ops.KERNELS}
        steps = engine.stats["decode_steps"]
        chunks = engine.stats["prefill_chunks"]
        for req, res in zip(reqs_x, results):
            require(res.finish_reason == "length" and len(res.tokens) == 16
                    and all(0 <= t < cfg_x.vocab_size for t in res.tokens),
                    f"{label} request {req.uid}: {res.finish_reason}, "
                    f"{res.tokens}")
        require(engine.allocator.n_free == engine.allocator.capacity,
                f"{label}: blocks leaked after the drain")
        expect = {k.name: 0 for k in ops.KERNELS}
        expect.update(want(steps, chunks))
        require(counts == expect,
                f"{label}: launches while serving {counts} do not match "
                f"{steps} decode steps and {chunks} prefill chunks ({expect})")
        ttft = [r.ttft_s * 1e3 for r in results]
        print(f"[{label}] 8 requests on 4 slots, prompts "
              f"{[len(r.prompt) for r in reqs_x]}, 16 new tokens each, page "
              f"16, chunk 64: {n_new} tokens in {wall:.3f} s = "
              f"{n_new / wall:.1f} tok/s; TTFT mean {np.mean(ttft):.1f} ms, "
              f"max {max(ttft):.1f} ms; {steps} decode steps, {chunks} "
              f"prefill chunks; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        return engine, results, counts

    def margin(lg, served, vocab):
        """Per served token (one row of ``lg`` each): how far its logit is
        below the best, and whether the step is decided (top-1/top-2 gap
        over MARGIN)."""
        require(lg.shape == (16, vocab) and bool(torch.isfinite(lg).all()),
                f"logits of shape {tuple(lg.shape)}, or not finite")
        top2 = lg.topk(2, dim=-1).values
        served = torch.as_tensor(served, device=dev)
        gap = top2[:, 0] - lg.gather(1, served[:, None])[:, 0]
        return gap, (top2[:, 0] - top2[:, 1]) > MARGIN

    def hold(lg, served, what, vocab=cfg.vocab_size):
        """The margin rule: each served token's logit within MARGIN of the
        best, and the argmax where the top-1/top-2 gap exceeds MARGIN.
        Returns (argmax hits, gated steps, worst gap)."""
        gap, decided = margin(lg, served, vocab)
        require(bool((gap <= MARGIN).all()), f"{what}: a served token is "
                f"{gap.max().item():.4f} below the reference's best")
        require(bool((gap[decided] == 0).all()),
                f"{what}: served token differs from the clear argmax")
        return int((gap == 0).sum()), int(decided.sum()), gap.max().item()

    def forward_logits(params_x, req, tokens, cfg_x=cfg):
        seq = np.concatenate([req.prompt, tokens[:-1]])
        lg = logits_fn(params_x, cfg_x, forward(
            params_x, cfg_x, torch.as_tensor(seq, device=dev)[None]))
        return lg[0, len(req.prompt) - 1:]

    engine, results, serve_counts = serve(
        cfg, params, "serve", lambda steps, chunks: {
            "gemm": 3 * L * (steps + chunks), "paged_attention": L * steps})
    bf16_bytes = engine.param_bytes, engine.kv_pool_bytes
    print(f"[serve] launches while serving {serve_counts} (per decode step: "
          f"gemm {3 * L}, paged_attention {L}; per prefill chunk: gemm "
          f"{3 * L}); weights {bf16_bytes[0] / 1e9:.3f} GB, KV pools "
          f"{bf16_bytes[1] / 1e9:.3f} GB")

    # ---- 5. forward, teacher-forced on the served tokens ---------------
    for k in ops.KERNELS:
        k.launches = 0
    worst, exact, gated = 0.0, 0, 0
    fwd_ms = []
    for req, res in zip(reqs, results):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = forward_logits(params, req, res.tokens)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        e, g, w = hold(lg, res.tokens, f"request {req.uid} vs forward")
        exact, gated, worst = exact + e, gated + g, max(worst, w)
    fwd_counts = {k.name: k.launches for k in ops.KERNELS}
    require(fwd_counts == {**{k.name: 0 for k in ops.KERNELS},
                           "gemm": 3 * L * 8, "flash_attention": L * 8},
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

    def profile_serving(cfg_x, params_x, label, reqs_x=None):
        engine = ServeEngine(cfg_x, params_x, **engine_kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run(reqs_x or reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                            for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA),
                           reverse=True)
        busy_ms = sum(t for t, _, _ in by_kernel) / 1e3
        print(f"[{label}] serving run under the profiler: wall "
              f"{wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / (wall * 1e3):.1f}%)")
        for t, n, key in by_kernel[:10]:
            print(f"[{label}] {t / 1e3:9.2f} ms {n:6d} x {key[:90]}")

    profile_serving(cfg, params, "profile")

    # ---- 7. the quantized rungs ----------------------------------------
    # The bf16 weights wait on the host, so that each rung's peak device
    # memory counts its own weights, pools and activations only.
    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    params_host = to(params, "cpu")
    del params, engine, lg
    n_blocks = -(-engine_kw["max_len"] // 16) + 1
    table = torch.arange(1, n_blocks, dtype=torch.int32, device=dev)[None]
    rung_counts = {}
    for wd, kd in (("int8", "int8"), ("int4", "fp8")):
        gc.collect()     # the previous rung's tensors (and profiler)
        label = f"serve_{wd}" if wd == kd else f"serve_{wd}_{kd}"
        cfg_q = cfg.replace(weight_dtype=wd, kv_dtype=kd, quant_block=32)
        qparams = quantize_params(to(params_host, dev), cfg_q)
        engine, q_results, counts = serve(
            cfg_q, qparams, label, lambda steps, chunks: {
                "gemm_wq": 3 * L * (steps + chunks),
                "paged_attention_quant": L * steps})
        rung_counts[label] = counts
        w_bytes, kv_bytes = engine.param_bytes, engine.kv_pool_bytes
        print(f"[{label}] launches while serving {counts} (per decode step: "
              f"gemm_wq {3 * L}, paged_attention_quant {L}; per prefill "
              f"chunk: gemm_wq {3 * L}); weights {w_bytes / 1e9:.3f} GB = "
              f"{w_bytes / bf16_bytes[0]:.4f} x bf16, KV pools "
              f"{kv_bytes / 1e9:.3f} GB = {kv_bytes / bf16_bytes[1]:.4f} x "
              f"bf16")
        del engine
        if profile_rungs:
            profile_serving(cfg_q, qparams, f"profile_{label}")
        # the gate: each request alone through the rung's model-level path
        worst, exact, gated = 0.0, 0, 0
        replays = []
        for req, res in zip(reqs, q_results):
            cache = init_cache(cfg_q, n_blocks, 16, dev)
            prompt = torch.as_tensor(req.prompt, device=dev)[None]
            for off in range(0, prompt.shape[1], 64):
                last = extend_step(qparams, cfg_q, cache,
                                   prompt[:, off:off + 64], off, 0, table)
            rows = [last[0, 0]]
            for i, tok in enumerate(res.tokens[:-1]):
                pos = torch.tensor([prompt.shape[1] + i], device=dev)
                rows.append(decode_step(qparams, cfg_q, cache,
                                        torch.tensor([[tok]], device=dev),
                                        pos, table)[0, 0])
            replays.append(torch.stack(rows))
            e, g, w = hold(replays[-1], res.tokens,
                           f"{label} request {req.uid} vs its replay")
            exact, gated, worst = exact + e, gated + g, max(worst, w)
        print(f"[{label}] served tokens vs each request replayed alone "
              f"(extend_step chunks of 64, then decode_step): exact argmax "
              f"{exact}/{n_new}, {gated} steps with a top-1/top-2 gap > "
              f"{MARGIN} all equal, worst gap {worst:.4f} (margin {MARGIN})")
        del qparams, cache
        # agreement with the bf16 model, teacher-forced on the rung's
        # tokens (reported only): argmax hits and the cosine similarity of
        # the rung's logits to bf16's at the same positions
        params_dev = to(params_host, dev)
        agree, cos = 0, []
        for req, res, rows in zip(reqs, q_results, replays):
            lg = forward_logits(params_dev, req, res.tokens)
            agree += int((lg.argmax(-1).cpu() == torch.tensor(res.tokens))
                         .sum())
            cos.append(F.cosine_similarity(rows, lg, dim=-1).mean().item())
        same = sum(a == b for r, q in zip(results, q_results)
                   for a, b in zip(r.tokens, q.tokens))
        print(f"[{label}] agreement with bf16 (not gated): the bf16 model's "
              f"argmax equals the served token at {agree}/{n_new} "
              f"teacher-forced steps; logit cosine similarity to bf16 mean "
              f"{np.mean(cos):.4f} (min over requests {min(cos):.4f}); "
              f"free-running tokens equal to the bf16 run's {same}/{n_new}")
        del params_dev, replays, rows, lg

    # ---- 8. serve full-width falcon-mamba-7b ---------------------------
    del params_host, q_results
    gc.collect()
    torch.cuda.empty_cache()
    FL = fm.n_layers
    t0 = time.perf_counter()
    fparams = init(fm, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in fparams["blocks"].values()) + sum(
        t.numel() for k, t in fparams.items() if k != "blocks")
    print(f"[serve_falcon_mamba] {fm.name}: {FL} mamba layers, d_model "
          f"{fm.d_model}, d_inner {fm.d_inner}, d_state {fm.ssm.d_state}, "
          f"dt_rank {fm.dt_rank}, vocab {fm.vocab_size}; "
          f"{n_params / 1e9:.3f} B params, drawn from torch.Generator seed "
          f"{SEED} in {time.perf_counter() - t0:.2f} s; device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after "
          f"init")
    frng = np.random.default_rng(SEED)
    freqs = [Request(uid=i, prompt=frng.integers(0, fm.vocab_size,
                                                 int(frng.integers(40, 201))),
                     max_new_tokens=16) for i in range(8)]
    chunk = engine_kw["prefill_chunk"]
    lens = [len(r.prompt) + 15 for r in freqs]
    # one lru_scan launch per layer per run of up to ssm.chunk tokens: one
    # per prefill chunk and one per forward
    require(fm.ssm.chunk >= max(chunk, *lens), "ssm.chunk below a prefill "
            "chunk or a forward's length")
    table = torch.zeros((1, 1), dtype=torch.int32, device=dev)

    def replay(cfg_x, params_x, req, tokens):
        """One request alone through the model-level serving path:
        ``extend_step`` in the engine's chunks, then ``decode_step`` fed
        the served tokens, in slot 0. Row i scores the token at
        len(prompt) + i."""
        cache = init_cache(cfg_x, 1, 16, dev, slots=1)
        slot = torch.zeros(1, dtype=torch.long, device=dev)
        prompt = torch.as_tensor(req.prompt, device=dev)[None]
        for off in range(0, prompt.shape[1], chunk):
            last = extend_step(params_x, cfg_x, cache,
                               prompt[:, off:off + chunk], off, 0, table)
        rows = [last[0, 0]]
        for i, tok in enumerate(tokens[:-1]):
            pos = torch.tensor([prompt.shape[1] + i], device=dev)
            rows.append(decode_step(params_x, cfg_x, cache,
                                    torch.tensor([[tok]], device=dev), pos,
                                    table, slots=slot)[0, 0])
        return torch.stack(rows)

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    fm_counts = {}

    def falcon_pass(cfg_x, params_x, label):
        """Serve the trace, then ``forward`` on each request with its served
        tokens appended, each counted; then each request replayed alone.
        Returns the results, forward's logits and the replays' logits."""
        engine, res_x, counts = serve(
            cfg_x, params_x, f"serve_{label}",
            lambda steps, chunks: {"lru_scan": FL * chunks}, freqs)
        fm_counts[f"serve_{label}"] = counts
        print(f"[serve_{label}] launches while serving {counts} (lru_scan "
              f"{FL} per prefill chunk; decode steps run the recurrence in "
              f"plain torch); weights "
              f"{engine.param_bytes / 1e9:.3f} GB, recurrent state of 4 "
              f"slots {engine.kv_pool_bytes / 1e9:.4f} GB")
        del engine
        if profile_rungs:
            profile_serving(cfg_x, params_x, f"profile_{label}", freqs)
        for k in ops.KERNELS:
            k.launches = 0
        fwd_ms, fwd_rows = [], []
        for req, res in zip(freqs, res_x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd_rows.append(forward_logits(params_x, req, res.tokens, cfg_x))
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k.name: k.launches for k in ops.KERNELS}
        require(counts == {**{k.name: 0 for k in ops.KERNELS},
                           "lru_scan": FL * len(freqs)},
                f"launches in the 8 {label} forward passes {counts}")
        fm_counts[f"forward_{label}"] = counts
        print(f"[forward_{label}] 8 teacher-forced passes of "
              f"{min(lens)}-{max(lens)} tokens, mean {np.mean(fwd_ms):.1f} "
              f"ms each; launches {counts} (per forward: lru_scan {FL})")
        rep_rows = [replay(cfg_x, params_x, req, res.tokens)
                    for req, res in zip(freqs, res_x)]
        return res_x, fwd_rows, rep_rows

    def hold_all(rows_x, res_x, what):
        worst, exact, gated = 0.0, 0, 0
        for req, res, lg in zip(freqs, res_x, rows_x):
            e, g, w = hold(lg, res.tokens, f"request {req.uid} vs {what}",
                           fm.vocab_size)
            exact, gated, worst = exact + e, gated + g, max(worst, w)
        return (f"exact argmax {exact}/{n_new}, {gated} steps with a "
                f"top-1/top-2 gap > {MARGIN} all equal, worst gap "
                f"{worst:.4f} (margin {MARGIN})")

    def apart(rows_a, rows_b):
        return max((a - b).abs().max().item() for a, b in zip(rows_a, rows_b))

    # bf16. Served tokens hold by the margin rule to each request replayed
    # alone (extend_step chunks of 64, then decode_step).
    res_b, fwd_b, rep_b = falcon_pass(fm, fparams, "falcon_mamba")
    print(f"[falcon_mamba] served tokens vs their replay (gated): "
          f"{hold_all(rep_b, res_b, 'its replay')}")
    fexact, fworst = 0, 0.0
    for res, lg in zip(res_b, fwd_b):
        gap, _ = margin(lg, res.tokens, fm.vocab_size)
        fexact, fworst = fexact + int((gap == 0).sum()), max(
            fworst, gap.max().item())
    print(f"[falcon_mamba] served tokens vs bf16 forward (reported, not "
          f"gated): exact argmax {fexact}/{n_new}, worst gap {fworst:.4f}")

    # float32, the same weights: served tokens hold to forward by the rule.
    fm32 = fm.replace(dtype="float32")
    params32 = f32(fparams)
    res_f, fwd_f, rep_f = falcon_pass(fm32, params32, "falcon_mamba_f32")
    print(f"[falcon_mamba_f32] served tokens vs forward (gated): "
          f"{hold_all(fwd_f, res_f, 'forward')}; replay vs forward logits "
          f"max |diff| {apart(rep_f, fwd_f):.3e}")

    # The witness for bf16: float32 forward of the same weights,
    # teacher-forced on the bf16 served tokens. bf16 forward and the bf16
    # serving path (its replay) must each lie within BF16_LOGIT_TOL of it,
    # and within BF16_LOGIT_TOL of each other.
    wit = [forward_logits(params32, req, res.tokens, fm32)
           for req, res in zip(freqs, res_b)]
    pairs = {"forward": (fwd_b, wit), "replay": (rep_b, wit),
             "replay vs forward": (rep_b, fwd_b)}
    spread = {k: apart(*v) for k, v in pairs.items()}
    mean = {k: np.mean([(a - b).abs().mean().item() for a, b in zip(*v)])
            for k, v in pairs.items()}
    scale = max(w.abs().max().item() for w in wit)
    print(f"[falcon_mamba] bf16 logits vs float32 forward of the same "
          f"weights on the bf16 tokens: max |diff| "
          + ", ".join(f"{k} {v:.4f}" for k, v in spread.items())
          + f" (limit {BF16_LOGIT_TOL}); mean |diff| "
          + ", ".join(f"{k} {v:.5f}" for k, v in mean.items())
          + f"; float32 logits up to {scale:.3f}")
    for what, diff in spread.items():
        require(diff <= BF16_LOGIT_TOL, f"bf16 falcon-mamba {what}: logits "
                f"{diff:.4f} from the float32 witness, over {BF16_LOGIT_TOL}")
    del fparams, params32, fwd_b, rep_b, fwd_f, rep_f, wit

    # ---- 9. serve full-width qwen2-moe-a2.7b ---------------------------
    gc.collect()
    torch.cuda.empty_cache()
    ML = qm.n_layers
    t0 = time.perf_counter()
    mparams = init(qm, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in mparams["blocks"].values()) + sum(
        t.numel() for k, t in mparams.items() if k != "blocks")
    print(f"[serve_moe] {qm.name}: {ML} layers, d_model {qm.d_model}, "
          f"{qm.n_heads}/{qm.n_kv_heads} heads of {qm.resolved_head_dim}, "
          f"{qm.moe.n_experts} experts of {qm.moe.d_expert}, top "
          f"{qm.moe.top_k}, shared {qm.moe.shared_hidden}, vocab "
          f"{qm.vocab_size}; {n_params / 1e9:.3f} B params, bf16 "
          f"{2 * n_params / 1e9:.2f} GB, drawn from torch.Generator seed "
          f"{SEED} in {time.perf_counter() - t0:.2f} s")
    mrng = np.random.default_rng(SEED)
    mreqs = [Request(uid=i, prompt=mrng.integers(0, qm.vocab_size,
                                                 int(mrng.integers(40, 201))),
                     max_new_tokens=16) for i in range(8)]
    engine, res_m, moe_counts = serve(
        qm, mparams, "serve_moe", lambda steps, chunks: {
            "packed_gather": ML * (steps + chunks),
            "gemm": 3 * ML * (steps + chunks),
            "paged_attention": ML * steps}, mreqs)
    steps_m = engine.steps
    print(f"[serve_moe] launches while serving {moe_counts} (per decode "
          f"step: packed_gather {ML}, gemm {3 * ML}, paged_attention {ML}; "
          f"per prefill chunk: packed_gather {ML}, gemm {3 * ML}); weights "
          f"{engine.param_bytes / 1e9:.3f} GB, KV pools "
          f"{engine.kv_pool_bytes / 1e9:.3f} GB")
    del engine
    if profile_rungs:
        profile_serving(qm, mparams, "profile_moe", mreqs)

    # Gate 1: the engine's recorded steps replayed through extend_step (its
    # chunks, padded length prefill_chunk) and decode_step (the same rows),
    # teacher-forced on the served tokens, each request in pages of its
    # own. A MoE layer's capacity drops depend on which rows decode
    # together, so the served tokens can only be held to the same steps.
    P_m = -(-engine_kw["max_len"] // 16)
    cache = init_cache(qm, 1 + len(mreqs) * P_m, 16, dev)
    tables_m = torch.zeros((engine_kw["max_slots"], P_m), dtype=torch.int32,
                           device=dev)
    prompts_m = {r.uid: torch.as_tensor(r.prompt, device=dev) for r in mreqs}
    served_m = {r.uid: res.tokens for r, res in zip(mreqs, res_m)}
    rows_m = {r.uid: [] for r in mreqs}
    for step in steps_m:
        if step[0] == "prefill_chunk":
            _, uid, slot, off, n = step
            if off == 0:
                tables_m[slot] = 1 + uid * P_m + torch.arange(P_m,
                                                              device=dev)
            lg = extend_step(mparams, qm, cache,
                             prompts_m[uid][None, off:off + n], off, slot,
                             tables_m, padded_len=engine_kw["prefill_chunk"])
            if off + n == len(prompts_m[uid]):
                rows_m[uid].append(lg[0, 0])
        else:
            _, uids, slots, pos = step
            feed = [[served_m[u][p - len(prompts_m[u])]]
                    for u, p in zip(uids, pos)]
            lg = decode_step(mparams, qm, cache,
                             torch.tensor(feed, device=dev),
                             torch.tensor(pos, device=dev),
                             tables_m[torch.tensor(slots, device=dev)])
            for u, row in zip(uids, lg[:, 0]):
                rows_m[u].append(row)
    worst, exact, gated = 0.0, 0, 0
    for req, res in zip(mreqs, res_m):
        e, g, w = hold(torch.stack(rows_m[req.uid]), res.tokens,
                       f"moe request {req.uid} vs the replay of its steps",
                       qm.vocab_size)
        exact, gated, worst = exact + e, gated + g, max(worst, w)
    n_dec = [len(st[1]) for st in steps_m if st[0] == "decode"]
    print(f"[serve_moe] served tokens vs the replay of the engine's "
          f"{len(steps_m)} steps ({len(n_dec)} decode steps of "
          f"{min(n_dec)}-{max(n_dec)} rows): exact argmax {exact}/{n_new}, "
          f"{gated} steps with a top-1/top-2 gap > {MARGIN} all equal, "
          f"worst gap {worst:.4f} (margin {MARGIN})")
    del cache, rows_m, lg

    # Gate 2, an independent witness: layer 0's moe_forward in bf16 at the
    # decode shape (4 rows, one group) and the chunk shape (64 tokens)
    # against moe_oracle in float32 on the same bf16 inputs. Inputs lie
    # around one common direction so that tokens share experts and the
    # capacity drops assignments. The routing (experts and keep mask) must
    # be identical, the output within MOE_ATOL + MOE_RTOL * |want|.
    require(qm.act == "silu", "moe_oracle's shared expert is a silu MLP")
    lp0 = {k: v[0] for k, v in mparams["blocks"].items()}
    for shape in ((4, 1), (1, 64)):
        base = torch.randn(qm.d_model, generator=gen, device=dev)
        x = (base + 0.7 * torch.randn(shape + (qm.d_model,), generator=gen,
                                      device=dev)).bfloat16()
        got = moe.moe_forward(lp0, qm, x)
        want, o_idx, o_keep = moe_oracle(lp0, qm.moe, x)
        G_ = x.shape[0] if x.shape[1] > 1 else 1
        xg = x.reshape(G_, -1, qm.d_model)
        _, p_idx = moe._route(lp0, qm.moe, xg.float())
        C_ = moe.capacity(qm.moe, xg.shape[1])
        _, (dest, order) = moe._dispatch_sort(xg, p_idx, C_,
                                              qm.moe.n_experts)
        p_keep = torch.empty_like(dest, dtype=torch.bool)
        p_keep[order] = dest < G_ * qm.moe.n_experts * C_
        p_keep = p_keep.view_as(o_keep)
        drops = int((~o_keep).sum())
        err = (got.float() - want).abs()
        ok = bool((err <= MOE_ATOL + MOE_RTOL * want.abs()).all())
        print(f"[moe_layer] layer 0 at {shape[0]}x{shape[1]} tokens (C = "
              f"{C_}): routing identical "
              f"{torch.equal(p_idx, o_idx) and torch.equal(p_keep, o_keep)}"
              f", {drops} of {o_keep.numel()} assignments dropped; bf16 vs "
              f"float32 oracle max |diff| {err.max().item():.5f}, mean "
              f"{err.mean().item():.6f}, max |want| "
              f"{want.abs().max().item():.3f} (limit {MOE_ATOL} + "
              f"{MOE_RTOL} |want|)")
        require(torch.equal(p_idx, o_idx) and torch.equal(p_keep, o_keep),
                f"moe layer at {shape}: routing differs from the oracle's")
        require(drops > 0, f"moe layer at {shape}: no assignment dropped, "
                "so the capacity rule went untested")
        require(bool(torch.isfinite(got.float()).all()) and ok,
                f"moe layer at {shape}: {err.max().item():.4f} from the "
                "float32 oracle")
    del lp0, got, want, x

    # forward on each prompt with its served tokens appended: counted, and
    # finite logits of the right shape. forward routes a whole sequence as
    # one group, so its drops differ from chunked serving's and its argmax
    # is reported, not gated.
    for k in ops.KERNELS:
        k.launches = 0
    agree, fwd_ms = 0, []
    for req, res in zip(mreqs, res_m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = forward_logits(mparams, req, res.tokens, qm)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        require(lg.shape == (16, qm.vocab_size)
                and bool(torch.isfinite(lg).all()),
                f"moe forward logits of shape {tuple(lg.shape)}, or not "
                "finite")
        agree += int((lg.argmax(-1).cpu() == torch.tensor(res.tokens)).sum())
    moe_fwd_counts = {k.name: k.launches for k in ops.KERNELS}
    require(moe_fwd_counts == {**{k.name: 0 for k in ops.KERNELS},
                               "gemm": 3 * ML * 8, "packed_gather": ML * 8,
                               "flash_attention": ML * 8},
            f"launches in the 8 moe forward passes {moe_fwd_counts}")
    mlens = [len(r.prompt) + 15 for r in mreqs]
    print(f"[forward_moe] 8 teacher-forced passes of {min(mlens)}-"
          f"{max(mlens)} tokens, mean {np.mean(fwd_ms):.1f} ms each; "
          f"launches {moe_fwd_counts} (per forward: gemm {3 * ML}, "
          f"packed_gather {ML}, flash_attention {ML}); forward's argmax "
          f"equals the served token at {agree}/{n_new} steps (reported, "
          f"not gated: whole-sequence routing drops other assignments)")
    fm_counts["serve_moe"], fm_counts["forward_moe"] = (moe_counts,
                                                        moe_fwd_counts)
    del mparams, lg

    # ---- 10. summary lines ---------------------------------------------
    kernels = []
    root = Path(__file__).resolve().parent
    for k in ops.KERNELS:
        e = entries[k.name]
        by_path = {"serve": serve_counts[k.name],
                   **{lbl: c[k.name] for lbl, c in rung_counts.items()},
                   "forward": fwd_counts[k.name],
                   **{lbl: c[k.name] for lbl, c in fm_counts.items()}}
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": str(k.source.relative_to(root)),
            "replaces": k.replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
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
