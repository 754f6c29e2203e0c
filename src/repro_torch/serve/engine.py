"""Fixed-batch facade over the continuous-batching scheduler (port of
`repro.serve.engine`).

`ServeEngine.generate` keeps the synchronous API — one batch of prompts
in, a (B, max_new_tokens) token matrix out — and runs on `Scheduler`:
every prompt becomes a `Request` and the batch becomes a slot pool of
width B.  `temperature`, `top_k` and `top_p` apply to every prompt (0 =
greedy); `spec` turns on speculative decoding (`serve/spec`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.serve.request import Request, SamplingParams, ServeStats
from repro_torch.serve.scheduler import Scheduler

__all__ = ["ServeEngine", "ServeStats"]


class ServeEngine:
    def __init__(self, cfg, params, max_seq: int = 512, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, decode_chunk: int = 8,
                 page: int | None = 64, n_pages: int | str | None = "auto",
                 spec=None, packed: str = "auto", device="cuda"):
        self.cfg = cfg
        self.params = params
        self.packed = packed
        self.max_seq = max_seq
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.decode_chunk = decode_chunk
        self.spec = spec
        self.page = page
        self.n_pages = n_pages
        self.device = resolve_device(device)
        self._sched: Scheduler | None = None

    def _scheduler(self, batch: int, rng_seed: int) -> Scheduler:
        if self._sched is None or self._sched.max_slots != batch:
            self._sched = Scheduler(
                self.cfg, self.params, max_slots=batch, max_seq=self.max_seq,
                decode_chunk=self.decode_chunk, rng_seed=rng_seed, page=self.page,
                n_pages=self.n_pages, spec=self.spec, packed=self.packed,
                device=self.device)
        else:
            self._sched.reset(rng_seed)
        return self._sched

    def generate(self, prompts: np.ndarray,          # (B, S_prompt) int32
                 max_new_tokens: int = 32,
                 rng_seed: int = 0) -> tuple[np.ndarray, ServeStats]:
        b = prompts.shape[0]
        sched = self._scheduler(b, rng_seed)
        reqs = [Request(rid=i, prompt=np.asarray(prompts[i], np.int32),
                        params=SamplingParams(max_new_tokens=max_new_tokens,
                                              temperature=self.temperature,
                                              top_k=self.top_k, top_p=self.top_p))
                for i in range(b)]
        sched.run(reqs)
        # EOS-terminated rows are zero-padded to the fixed output width
        out = np.zeros((b, max_new_tokens), dtype=np.int32)
        for r in reqs:
            out[r.rid, : r.n_generated] = r.tokens
        return out, dataclasses.replace(sched.stats)
