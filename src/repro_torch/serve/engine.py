"""Continuous-batching greedy serving over a paged KV cache
(``repro/serve/engine.py``, FCFS core).

The engine owns ``max_slots`` sequence slots over one pool of KV blocks
(``models/cache.py``). Admission is first come, first served: the request at
the head of the queue takes a free slot once the allocator can grant blocks
for its ``len(prompt) + max_new_tokens`` tokens, and nothing overtakes it
while it waits. Each :meth:`ServeEngine.step` advances every prefilling slot
by one chunk of ``prefill_chunk`` tokens (``extend_step``), then runs one
decode step over every decoding slot (``decode_step``), so a long prompt
never stalls the running slots. Sampling is greedy: the argmax is taken on
the device and only the chosen token ids reach the host. A request's blocks
return to the pool the moment it finishes.

Not ported yet (``ROADMAP.md``): prefix caching, preemption, overlapped
decode, priority scheduling, temperature sampling, speculative decoding and
forks, quantized pools, sharded pools, telemetry.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import decode_step, extend_step
from repro_torch.models.cache import (default_n_blocks, init_cache,
                                      pages_per_slot)

#: Slot lifecycle: FREE -> PREFILL (chunked) -> DECODE -> FREE.
FREE, PREFILL, DECODE = 0, 1, 2


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                      # (S,) int token ids
    max_new_tokens: int = 16


@dataclass
class Result:
    uid: int
    tokens: list[int] = field(default_factory=list)
    finish_reason: str = ""                 # eos | length | rejected
    detail: str = ""                        # rejection cause
    decode_steps: int = 0
    submit_s: float = 0.0                   # perf_counter at submit
    token_ts: list[float] = field(default_factory=list)  # one per token

    @property
    def ttft_s(self) -> float | None:
        """Submit-to-first-token latency (queueing + prefill)."""
        return (self.token_ts[0] - self.submit_s) if self.token_ts else None


class BlockAllocator:
    """Free list over the KV block pool. Block 0 is the null block and is
    never handed out. A grant is all or nothing; releasing a block that is
    not held raises instead of corrupting the free list."""

    def __init__(self, n_blocks: int, page_size: int):
        self.n_blocks, self.page_size = n_blocks, page_size
        self._free = list(range(n_blocks - 1, 0, -1))
        self._held = np.zeros(n_blocks, bool)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        return self.n_blocks - 1

    def pages_for(self, n_tokens: int) -> int:
        return pages_per_slot(n_tokens, self.page_size)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(f"allocator exhausted: want {n}, "
                               f"free {len(self._free)}")
        got = [self._free.pop() for _ in range(n)]
        self._held[got] = True
        return got

    def release(self, blocks: list[int]) -> None:
        for blk in blocks:
            if not self._held[blk]:
                raise RuntimeError(f"release of block {blk}, which is free")
            self._held[blk] = False
            self._free.append(blk)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *, max_slots: int = 4,
                 max_len: int = 512, eos_id: int | None = None,
                 page_size: int | None = None,
                 prefill_chunk: int | None = None,
                 max_blocks: int | None = None, device: str = "cuda"):
        self.device = resolve(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.cfg, self.params = cfg, params
        self.max_slots, self.max_len, self.eos_id = max_slots, max_len, eos_id
        self.page_size = page_size or cfg.page_size
        self.prefill_chunk = prefill_chunk or cfg.prefill_chunk
        n_blocks = max_blocks or default_n_blocks(max_slots, max_len,
                                                  self.page_size)
        self.allocator = BlockAllocator(n_blocks, self.page_size)
        self.n_pages = pages_per_slot(max_len, self.page_size)
        self.cache = init_cache(cfg, n_blocks, self.page_size, self.device)
        #: block tables, host copy and device copy, kept equal row by row
        self.block_tables = np.zeros((max_slots, self.n_pages), np.int32)
        self._tables = torch.zeros((max_slots, self.n_pages),
                                   dtype=torch.int32, device=self.device)
        self.phase = np.full(max_slots, FREE, np.int8)
        #: tokens written to the slot's cache (the next write position)
        self.slot_pos = np.zeros(max_slots, np.int64)
        self.slot_blocks: list[list[int]] = [[] for _ in range(max_slots)]
        self._slot_req: list[Request | None] = [None] * max_slots
        self.queue: deque[Request] = deque()
        self.results: dict[int, Result] = {}
        self.stats = {"prefills": 0, "prefill_chunks": 0, "decode_steps": 0,
                      "rejected": 0}

    # ---- requests ------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.results[req.uid] = Result(uid=req.uid,
                                       submit_s=time.perf_counter())
        self.queue.append(req)

    def _reject(self, req: Request, why: str) -> None:
        res = self.results[req.uid]
        res.finish_reason, res.detail = "rejected", why
        self.stats["rejected"] += 1

    def _emit(self, slot: int, tok: int) -> None:
        req = self._slot_req[slot]
        res = self.results[req.uid]
        res.tokens.append(tok)
        res.token_ts.append(time.perf_counter())
        if self.eos_id is not None and tok == self.eos_id:
            self._finish(slot, "eos")
        elif len(res.tokens) >= req.max_new_tokens:
            self._finish(slot, "length")

    def _set_table(self, slot: int, blocks: list[int]) -> None:
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(blocks)] = blocks
        self._tables[slot] = torch.from_numpy(self.block_tables[slot])

    def _finish(self, slot: int, reason: str) -> None:
        self.results[self._slot_req[slot].uid].finish_reason = reason
        self.allocator.release(self.slot_blocks[slot])
        self.slot_blocks[slot] = []
        self._set_table(slot, [])
        self._slot_req[slot] = None
        self.phase[slot] = FREE

    # ---- engine loop ---------------------------------------------------
    def _admit(self) -> None:
        """Place queued requests in free slots, in arrival order."""
        while self.queue:
            req = self.queue[0]
            n_tokens = len(req.prompt) + req.max_new_tokens
            prompt = np.asarray(req.prompt)
            if (len(prompt) == 0 or req.max_new_tokens < 1
                    or prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size):
                self.queue.popleft()
                self._reject(req, "empty prompt, no tokens requested, or a "
                                  "token id outside [0, "
                                  f"{self.cfg.vocab_size})")
                continue
            need = self.allocator.pages_for(n_tokens)
            if n_tokens > self.max_len or need > self.allocator.capacity:
                self.queue.popleft()
                self._reject(req, f"prompt+budget {n_tokens} tokens exceeds "
                                  f"max_len {self.max_len} or the pool "
                                  f"({self.allocator.capacity} blocks)")
                continue
            free = np.nonzero(self.phase == FREE)[0]
            if not len(free) or need > self.allocator.n_free:
                return                    # FCFS: the head waits, none pass
            self.queue.popleft()
            slot = int(free[0])
            self.slot_blocks[slot] = self.allocator.alloc(need)
            self._set_table(slot, self.slot_blocks[slot])
            self._slot_req[slot] = req
            self.slot_pos[slot] = 0
            self.phase[slot] = PREFILL
            self.stats["prefills"] += 1

    def _prefill_chunks(self) -> None:
        """Advance every prefilling slot by one chunk; a slot whose prompt
        is complete takes its first token from the last chunk's logits."""
        for slot in np.nonzero(self.phase == PREFILL)[0]:
            slot = int(slot)
            req = self._slot_req[slot]
            off = int(self.slot_pos[slot])
            t = min(self.prefill_chunk, len(req.prompt) - off)
            tokens = torch.as_tensor(np.asarray(req.prompt[off:off + t]),
                                     dtype=torch.long, device=self.device)
            logits = extend_step(self.params, self.cfg, self.cache,
                                 tokens[None], off, slot, self._tables)
            self.stats["prefill_chunks"] += 1
            self.slot_pos[slot] = off + t
            if off + t == len(req.prompt):
                first = int(logits[0, 0].argmax())
                self.phase[slot] = DECODE
                self._emit(slot, first)

    def _decode(self) -> None:
        """One decode step over every decoding slot, greedy on the device."""
        slots = np.nonzero(self.phase == DECODE)[0]
        if not len(slots):
            return
        last = [self.results[self._slot_req[s].uid].tokens[-1] for s in slots]
        dev = self.device
        tokens = torch.tensor(last, dtype=torch.long, device=dev)[:, None]
        pos = torch.as_tensor(self.slot_pos[slots], device=dev)
        idx = torch.as_tensor(slots, device=dev)
        logits = decode_step(self.params, self.cfg, self.cache, tokens, pos,
                             self._tables[idx])
        ids = logits[:, 0].argmax(-1).cpu().tolist()
        self.stats["decode_steps"] += 1
        self.slot_pos[slots] += 1
        for s, tok in zip(slots, ids):
            self.results[self._slot_req[s].uid].decode_steps += 1
            self._emit(int(s), tok)

    def step(self) -> int:
        """Admit, advance prefill by one chunk, decode one token. Returns
        the number of busy slots."""
        self._admit()
        self._prefill_chunks()
        self._decode()
        return int((self.phase != FREE).sum())

    def run(self, requests: list[Request], *, max_steps: int = 100000
            ) -> list[Result]:
        """Serve ``requests`` to completion; raises if they need more than
        ``max_steps`` steps."""
        for r in requests:
            self.submit(r)
        steps = 0
        while self.queue or (self.phase != FREE).any():
            if steps >= max_steps:
                raise RuntimeError(f"requests unfinished after {steps} steps")
            self.step()
            steps += 1
        return [self.results[r.uid] for r in requests]
