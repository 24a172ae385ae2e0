"""Serving launcher: the port's engine over synthetic greedy requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --requests 8 --slots 4 --max-new 16          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --weight-dtype int4 --kv-dtype fp8 --quant-block 32   # quantized
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Weights are random, drawn from a ``torch.Generator`` seeded by ``--seed``;
so are the prompts (numpy, same seed). Prints one JSON object, with the
served weights' bytes and the KV pools' bytes (a Mamba model's recurrent
state bytes).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import init
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV rows per block (default: cfg.page_size)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill tokens (default: cfg.prefill_chunk)")
    ap.add_argument("--weight-dtype", default=None,
                    choices=("int8", "fp8", "int4"),
                    help="weight-only quantization of the matmul weights "
                         "(int4 packs two codes per byte); the MLP runs the "
                         "gemm_wq kernel")
    ap.add_argument("--kv-dtype", default=None, choices=("int8", "fp8"),
                    help="quantized paged KV pools with per-row scales")
    ap.add_argument("--quant-block", type=int, default=None,
                    help="per-block weight-scale length (0 = per-channel)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    quant = {k: v for k, v in (("weight_dtype", args.weight_dtype),
                               ("kv_dtype", args.kv_dtype),
                               ("quant_block", args.quant_block))
             if v is not None}
    cfg = cfg.replace(**quant)
    params = init(cfg, seed=args.seed, device=args.device)
    engine = ServeEngine(cfg, params, max_slots=args.slots,
                         max_len=args.max_len, page_size=args.page_size,
                         prefill_chunk=args.prefill_chunk, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=uid,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(4, 32))),
                    max_new_tokens=args.max_new)
            for uid in range(args.requests)]
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    sync()
    dt = time.perf_counter() - t0
    new_tokens = sum(len(r.tokens) for r in results)
    print(json.dumps({
        "arch": cfg.name, "device": str(engine.device),
        "weight_dtype": cfg.weight_dtype or cfg.dtype,
        "kv_dtype": cfg.kv_dtype or cfg.dtype, "quant_block": cfg.quant_block,
        "weight_bytes": engine.param_bytes,
        "kv_pool_bytes": engine.kv_pool_bytes,
        "requests": len(results),
        "finished": sum(r.finish_reason in ("eos", "length") for r in results),
        "new_tokens": new_tokens, "wall_s": dt,
        "tok_per_s": new_tokens / dt,
        "ttft_mean_s": float(np.mean([r.ttft_s for r in results
                                      if r.ttft_s is not None])),
        **engine.stats}))
    if any(r.finish_reason not in ("eos", "length") for r in results):
        raise SystemExit("unfinished or rejected requests")


if __name__ == "__main__":
    main()
