"""Continuous-batching scheduler (port of `repro.serve.scheduler`).

The decode batch is a fixed-width pool of request slots (`SlotKVCache`).
Every scheduler step:

  1. admission — queued requests are prefilled, grouped by prompt-length
     bucket and padded with sentinel-masked rows, and inserted into free
     slots; a paged pool also gates admission on free KV pages.
     `policy="static"` instead gang-admits only when the pool is idle;
  2. decode — a chunk of `decode_chunk` decode steps with on-device
     sampling (greedy, or temperature / top-k / top-p per slot) and
     per-slot EOS / length early-exit masking, all on the device; the only
     host transfer is the (chunk, slots) emitted-token matrix once per
     chunk;
  3. harvest — emitted tokens are appended to their requests; finished
     slots are reset and returned to the free list.

Device programs.  Where the reference jits the prefill per bucket, the
whole decode chunk (one `lax.scan`), the n-gram proposal, the verify and
the fused speculative loop (`Scheduler._build`), the port runs each as a
captured CUDA graph (`serve/graphs.py`), keyed by the reference's static
arguments.  Their inputs and outputs never move: the per-slot state is
written in place, the chunk's and the spec loop's results land in static
output buffers, each prefill key owns its input buffers and stripe
template, and `reset` fills the same storage.  On a CPU device the same
bodies run eagerly.

Double-buffered admission (`async_admission`, on by default under the
continuous policy, as the reference's): while a decode chunk or spec
loop is in flight, the host prepares the next admission group — stages
its inputs in pinned memory and dispatches its prefill — and the group's
first-token sync and slot arming happen at the start of the next step
(`_commit_admissions`).  The emitted tokens come back through pinned
buffers and an event, so harvesting waits for the chunk alone, not for
the prefill queued behind it.

Inactive lanes keep stepping inside a chunk (fixed-shape batch); their
cache writes land under their own lane's `kpos` mask or on the scratch
page, and are wiped by the slot reset on reuse.

Sampling draws use per-slot, per-position keys (`sampler.fold_keys`, the
port's bit-exact threefry): a request's sampled stream depends only on
its seed and token index, never on its slot or co-residents.

With `spec=SpecConfig(...)` the decode phase runs draft/verify cycles
instead (`serve/spec`): the n-gram drafter proposes `k` tokens per slot,
one multi-token verify forward scores them all, and the pool keeps the
accepted rows while sweeping the rejected ones.  Greedy and "match"-mode
sampled requests emit exactly the non-speculative stream.

What waits for later slices: the model drafter, prefix sharing, chunked
prefill, telemetry, the flight recorder and multi-device meshes.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.core.types import PackedHiNM
from repro_torch.device import resolve_device, to_device
from repro_torch.models import zoo
from repro_torch.serve import prng, sampler
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.graphs import GraphCache
from repro_torch.serve.kv import SlotKVCache
from repro_torch.serve.request import Request, RequestState, ServeStats


def param_bytes(model) -> tuple[int, int]:
    """(packed, dense-equivalent) byte footprint of a model's weights."""
    packed = dense = 0
    for mod in model.modules():
        for t in mod._buffers.values():
            if t is not None:
                packed += t.numel() * t.element_size()
                dense += t.numel() * t.element_size()
        w = mod.__dict__.get("w")
        if isinstance(w, PackedHiNM):
            packed += w.packed_bytes()
            dense += w.dense_bytes()
    return packed, dense


class Scheduler:
    def __init__(self, cfg, params, max_slots: int = 4, max_seq: int = 512,
                 decode_chunk: int = 8, rng_seed: int = 0, policy: str = "continuous",
                 page: int | None = 64, n_pages: int | str | None = "auto",
                 spec: spec_mod.SpecConfig | None = None, packed: str = "auto",
                 async_admission: bool | str = "auto", device="cuda"):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if async_admission == "auto":
            async_admission = policy == "continuous"
        if async_admission and policy != "continuous":
            raise ValueError("async admission requires the continuous admission policy "
                             "(static gang admission is the synchronous baseline)")
        if packed not in ("auto", "pack"):
            raise ValueError(f"unknown packed-weights mode {packed!r}")
        if not zoo.supports_bucketed_prefill(cfg) or cfg.window:
            raise NotImplementedError(
                f"{cfg.name}: only length-bucketed prefill is ported (no recurrent "
                "state, no sliding window); see ROADMAP.md Queue 1 item 8")
        self.device = resolve_device(device)
        self.cfg = cfg
        # serve-time weight packing (one-time, here at construction, in
        # place on `params`): "pack" routes every planned q/k/v/o + MLP
        # projection through hinm_spmm; "auto" serves the weights as given
        if packed == "pack":
            params = zoo.pack_params(cfg, params)
        self.params = params
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.decode_chunk = decode_chunk
        self.policy = policy
        self._vocab = cfg.vocab
        eos = getattr(cfg, "eos_id", -1)
        # out-of-vocab EOS (full-tokenizer ids on reduced test configs)
        # disables EOS termination rather than matching a wrong token
        self.default_eos = eos if 0 <= eos < cfg.vocab else -1
        self.spec = spec
        self.drafter = None
        if spec is not None:
            self._check_spec(spec)
        self.kv = SlotKVCache(cfg, max_slots, max_seq, page=page, n_pages=n_pages,
                              device=self.device)
        # double-buffered admission: groups prepared under an in-flight
        # chunk await their first-token sync, holding the slots and pages
        # they will draw at commit
        self.async_admission = bool(async_admission)
        self._pending_admits: list[tuple] = []
        self._pending_slots = 0
        self._pending_pages = 0
        self._chunk_in_flight = False
        self._overlap_groups = 0        # groups whose prefill overlapped a chunk
        self.graphs = GraphCache(self.device)
        self._prefill_io: dict[tuple[int, int], dict] = {}
        self._queue: collections.deque[Request] = collections.deque()
        self._running: dict[int, Request] = {}
        self._active_host = np.zeros((max_slots,), bool)
        self._alloc_state()
        self._reset_state(rng_seed)
        pb, db = param_bytes(params)
        self.stats = ServeStats(0.0, 0.0, 0, pb, db)

    def _check_spec(self, spec) -> None:
        """Validate a SpecConfig, resolve its drafter and the cycle count."""
        cfg = self.cfg
        if not zoo.supports_spec_decode(cfg):
            raise ValueError(f"{cfg.family!r} (window={cfg.window}) has no "
                             "speculative verify path")
        if spec.k < 1:
            raise ValueError("SpecConfig.k must be >= 1")
        if spec.k + 1 > self.max_seq:
            raise ValueError("SpecConfig.k + 1 exceeds max_seq")
        if spec.cycles is not None and spec.cycles < 1:
            raise ValueError("SpecConfig.cycles must be >= 1 (or None for the "
                             "decode_chunk-derived default)")
        # fused: cycles cost no host round trip, so one per chunk step keeps
        # the non-spec chunk's token floor; unfused: about one chunk's worth
        # of emitted rows per step
        self._spec_cycles = (spec.cycles if spec.cycles is not None
                             else (self.decode_chunk if spec.fused
                                   else max(1, self.decode_chunk // (spec.k + 1))))
        d = spec.drafter
        if d == "ngram":
            d = spec_mod.NgramDrafter(spec.ngram)
        if d == "model" or getattr(d, "kind", None) == "model":
            raise ValueError(spec_mod.drafter.MODEL_DRAFTER_WAITS)
        if getattr(d, "kind", None) != "ngram":
            raise ValueError(f"unknown drafter {d!r}: pass \"ngram\" or an "
                             "NgramDrafter instance")
        self.drafter = d

    def _alloc_state(self) -> None:
        """The per-slot decode state and the decode programs' static output
        buffers, allocated once: graphs read and write this storage, so it
        is only ever filled in place."""
        s, dev = self.max_slots, self.device

        def vec(dtype, *shape):
            return torch.zeros(shape or (s,), dtype=dtype, device=dev)

        i32 = torch.int32
        self._tok = vec(i32, s, 1)
        self._active = vec(torch.bool)
        self._rem = vec(i32)
        self._temp = vec(torch.float32)
        self._topk = vec(i32)
        self._topp = vec(torch.float32)
        self._eos = vec(i32)
        self._seeds = vec(torch.int64)
        self._gens = vec(i32)
        self._keff = vec(i32)
        self._match = vec(torch.bool)
        # per-slot token history (prompt + emitted): the n-gram drafter's
        # lookup corpus, sized for prompt + max_new (max_seq bounds both)
        self._hist = vec(i32, s, self.max_seq)
        self._hlen = vec(i32)
        # base PRNG key, never split: every draw folds in (request seed,
        # token index), so streams are reproducible per request
        self._key = vec(torch.int64, 2)
        self._emits = vec(i32, self.decode_chunk, s)     # the chunk's (chunk, slots)
        if self.spec is not None:
            k1, cyc = self.spec.k + 1, self._spec_cycles
            # the spec loop's stacked results, and one verify's (unfused)
            self._spec_out = {"emits": vec(i32, cyc, s, k1), "cnt": vec(i32, cyc, s),
                              "judged": vec(i32, cyc, s)}
            self._verify_out = {"pos0": vec(i32), "emits": vec(i32, s, k1),
                                "cnt": vec(i32), "judged": vec(i32)}
            self._drafts = vec(i32, s, self.spec.k)

    def _reset_state(self, rng_seed: int) -> None:
        for t in (self._tok, self._active, self._rem, self._temp, self._topk, self._topp,
                  self._seeds, self._gens, self._keff, self._hist, self._hlen):
            t.zero_()
        self._eos.fill_(-1)
        self._match.fill_(True)
        self._key.copy_(prng.PRNGKey(rng_seed, device=self.device))
        self._active_host[:] = False

    def reset(self, rng_seed: int = 0) -> None:
        """Drop all queued/running requests and restore pristine state, in
        the same storage (the captured graphs stay valid)."""
        self._queue.clear()
        self._running.clear()
        self._pending_admits.clear()
        self._pending_slots = 0
        self._pending_pages = 0
        self._chunk_in_flight = False
        self.kv.reset_all()
        self._reset_state(rng_seed)
        self.stats = ServeStats(0.0, 0.0, 0, self.stats.packed_param_bytes,
                                self.stats.dense_param_bytes)

    # -- request lifecycle --------------------------------------------------

    @property
    def n_pending(self) -> int:
        return (len(self._queue) + len(self._running)
                + sum(len(rec[0]) for rec in self._pending_admits))

    def _reserve_rows(self, req: Request) -> int:
        """Cache rows this request may legally grow to (page budget)."""
        return len(req.prompt) + req.params.max_new_tokens

    def _bucket_len(self, n_tokens: int) -> int:
        """Power-of-two prompt-length bucket (from 8), clamped to the prefill
        stripe."""
        b = 8
        while b < n_tokens:
            b *= 2
        return max(n_tokens, min(b, self.max_seq))

    def submit(self, req: Request) -> None:
        rows = len(req.prompt)
        if rows + req.params.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid}: {rows} prompt rows + max_new_tokens "
                f"{req.params.max_new_tokens} exceeds max_seq {self.max_seq}")
        if (self.kv.paged and self.kv.pages_needed(self._reserve_rows(req))
                > self.kv.n_alloc_pages):
            raise ValueError(f"request {req.rid}: needs more KV pages than the "
                             "pool allocates — raise n_pages")
        if req.params.spec_accept not in ("match", "reject"):
            raise ValueError(f"request {req.rid}: unknown spec_accept "
                             f"{req.params.spec_accept!r}")
        req.state = RequestState.QUEUED
        req.submit_time = time.perf_counter()
        self._queue.append(req)

    def _eff_eos(self, req: Request) -> int:
        if req.params.eos_id is not None:
            return req.params.eos_id if 0 <= req.params.eos_id < self._vocab else -1
        return self.default_eos

    def _eff_seed(self, req: Request) -> int:
        return req.params.seed if req.params.seed is not None else req.rid

    def _eff_keff(self, req: Request) -> int:
        if self.spec is None:
            return 0
        k = req.params.spec_k
        return self.spec.k if k is None else max(0, min(k, self.spec.k))

    def _finish(self, req: Request, finished: list[Request]) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = time.perf_counter()
        eos = self._eff_eos(req)
        req.finish_reason = ("eos" if (eos >= 0 and req.tokens and req.tokens[-1] == eos)
                             else "length")
        self.stats.requests_finished += 1
        if req.finish_reason == "eos":
            self.stats.finished_at_eos += 1
        self.stats.observe_finish(req)
        finished.append(req)

    def _admit(self, finished: list[Request]) -> None:
        if self.policy == "static" and self._running:
            return  # gang admission: wait for the whole pool to drain
        # overlapped groups hold reservations: their slots and pages are
        # drawn only at commit, so gate on what is genuinely left
        while self._queue and self.kv.n_free - self._pending_slots > 0:
            # group the queue head by prompt-length bucket: one batched
            # prefill per group (one graph per bucket and width)
            def sig(r):
                return self._bucket_len(len(r.prompt))

            head_reserve = self._reserve_rows(self._queue[0])
            pages_left = self.kv.n_free_pages - self._pending_pages
            if self.kv.paged:
                pages_left -= self.kv.pages_needed(head_reserve)
                if pages_left < 0:
                    return  # FIFO head waits for releases, no starvation
            group = [self._queue.popleft()]
            while (self._queue and len(group) < self.kv.n_free - self._pending_slots
                   and sig(self._queue[0]) == sig(group[0])):
                if self.kv.paged:
                    need = self.kv.pages_needed(self._reserve_rows(self._queue[0]))
                    if need > pages_left:
                        break
                    pages_left -= need
                group.append(self._queue.popleft())
            self._admit_group(group, finished)

    def _prefill_buffers(self, s_b: int, k_b: int) -> dict:
        """The static inputs, stripe template and first-token output of the
        prefill graphs of one (bucket, width)."""
        io = self._prefill_io.get((s_b, k_b))
        if io is None:
            def vec(dtype, *shape):
                return torch.zeros(shape or (k_b,), dtype=dtype, device=self.device)

            io = self._prefill_io[(s_b, k_b)] = {
                "tokens": vec(torch.int32, k_b, s_b), "n_rows": vec(torch.int32),
                "seeds": vec(torch.int64), "temp": vec(torch.float32),
                "topk": vec(torch.int32), "topp": vec(torch.float32),
                "first": vec(torch.int32), "cache": self.kv.template(k_b)}
        return io

    def _prefill_body(self, io: dict, stochastic: bool):
        """Prefill `io`'s tokens into its stripe template and draw each
        row's first token (token index 0 of its stream)."""
        def body():
            cache = io["cache"]
            cache["pos"].zero_()    # the write offset of a pristine template
            last = zoo.prefill(self.params, self.cfg, io["tokens"], cache,
                               n_rows=io["n_rows"])
            logits = zoo.logits_fn(self.params, self.cfg, last)[:, : self._vocab].float()
            if stochastic:
                keys = sampler.fold_keys(self._key, io["seeds"],
                                         torch.zeros_like(io["seeds"]))
                first = sampler.sample(keys, logits, io["temp"], io["topk"], io["topp"])
            else:
                first = sampler.greedy(logits)
            io["first"].copy_(first)
        return body

    def _admit_group(self, group: list[Request], finished: list[Request]) -> None:
        """Prepare an admission group: stage its padded inputs and dispatch
        its prefill (no sync).  Synchronously, or with no chunk in flight,
        the group commits at once (`_commit_group`); a group prepared under
        an in-flight chunk waits for the next step's start, its prefill
        overlapping the chunk."""
        k = len(group)
        t0 = time.perf_counter()
        for req in group:
            req.state = RequestState.PREFILLING
            req.admit_time = t0
        # pad every prompt to the group's shared length bucket and the group
        # itself to a power-of-two width; padded rows/lanes are
        # sentinel-masked and discarded
        s_b = self._bucket_len(len(group[0].prompt))
        k_b = 1
        while k_b < k:
            k_b *= 2
        tokens = np.zeros((k_b, s_b), np.int32)
        padded = [group[min(i, k - 1)] for i in range(k_b)]
        for i, r in enumerate(padded):
            tokens[i, : len(r.prompt)] = r.prompt
        io = self._prefill_buffers(s_b, k_b)
        staged = {"tokens": tokens, "n_rows": [len(r.prompt) for r in padded]}
        stochastic = any(r.params.temperature > 0 for r in group)
        if stochastic:
            staged.update(seeds=[self._eff_seed(r) & prng.M32 for r in padded],
                          temp=[r.params.temperature for r in padded],
                          topk=[r.params.top_k for r in padded],
                          topp=[r.params.top_p for r in padded])
        for name, vals in staged.items():
            io[name].copy_(to_device(torch.tensor(vals, dtype=io[name].dtype), self.device))
        self.graphs.run(("prefill", s_b, k_b, stochastic), self._prefill_body(io, stochastic))
        first = self._fetch(io["first"])
        cache_k = io["cache"]
        self.stats.prefill_rows += sum(len(r.prompt) for r in group)
        if self.async_admission and self._chunk_in_flight:
            # overlapped: its host time hid under the chunk, so it is not
            # charged to prefill_seconds.  Another group of this bucket and
            # width may replay the same graph before this one commits, so
            # the group keeps its own copy of the stripe (its first tokens
            # are already on their way to the host)
            cache_k = {name: leaf.clone() for name, leaf in cache_k.items()}
            self._pending_admits.append((group, first, cache_k))
            self._pending_slots += k
            if self.kv.paged:
                self._pending_pages += sum(self.kv.pages_needed(self._reserve_rows(r))
                                           for r in group)
            self._overlap_groups += 1
            return
        self.stats.prefill_seconds += time.perf_counter() - t0
        self._commit_group((group, first, cache_k), finished)

    def _commit_admissions(self, finished: list[Request]) -> None:
        """Land every group prepared under the previous chunk: one
        first-token sync each (its prefill finished under the chunk), then
        slot arming."""
        pending, self._pending_admits = self._pending_admits, []
        self._pending_slots = 0
        self._pending_pages = 0
        for rec in pending:
            self._commit_group(rec, finished)

    def _commit_group(self, rec: tuple, finished: list[Request]) -> None:
        """One admission group's first-token sync (= TTFT), then its slots:
        insert the prefilled rows and arm the decode state."""
        group, first, cache_k = rec
        tc0 = time.perf_counter()
        (first_np,) = first()
        now = time.perf_counter()
        armed = []
        for row, req in enumerate(group):
            p = req.params
            eos = self._eff_eos(req)
            first_i = int(first_np[row])
            req.tokens.append(first_i)
            req.first_token_time = now
            self.stats.tokens_generated += 1
            if (eos >= 0 and first_i == eos) or p.max_new_tokens <= 1:
                # finished at its first token: never touch the slot pool
                self._finish(req, finished)
                continue
            slot = self.kv.acquire()
            self.kv.insert(slot, cache_k, len(req.prompt), row=row,
                           reserve=self._reserve_rows(req))
            armed.append((slot, req, first_i, eos))
            self._active_host[slot] = True
            req.state = RequestState.DECODING
            req.slot = slot
            self._running[slot] = req
        if armed:
            self._arm(armed)
        self.stats.prefill_seconds += time.perf_counter() - tc0

    def _overlap_admit(self, finished: list[Request]) -> None:
        """Double-buffered admission: called between a decode dispatch and
        its one sync, while the chunk is in flight.  The groups `_admit`
        prepares now queue their prefills behind the chunk and commit at
        the next step's start."""
        if not self.async_admission:
            return
        self._chunk_in_flight = True
        self._admit(finished)
        self._chunk_in_flight = False

    def _fetch(self, *tensors: torch.Tensor):
        """Start copying `tensors` to the host.  Returns a function that
        waits for these copies alone (the stream may hold more work by
        then: an overlapped prefill) and gives them as numpy arrays.  On
        CUDA they land in pinned memory behind an event."""
        if self.device.type != "cuda":
            host = [t.clone() for t in tensors]
            return lambda: [h.numpy() for h in host]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def wait():
            done.synchronize()
            return [h.numpy() for h in host]
        return wait

    def _arm(self, armed: list[tuple]) -> None:
        """Arm the per-slot decode state of freshly admitted slots, in
        place, one copy per state vector: (slot, request, first token,
        effective EOS)."""
        idx = to_device(torch.tensor([a[0] for a in armed]), self.device)

        def put(dst, vals):
            dst[idx] = to_device(torch.tensor(vals, dtype=dst.dtype), self.device)

        reqs = [a[1] for a in armed]
        put(self._tok[:, 0], [a[2] for a in armed])
        put(self._active, [True] * len(armed))
        put(self._rem, [r.params.max_new_tokens - 1 for r in reqs])
        put(self._temp, [r.params.temperature for r in reqs])
        put(self._topk, [r.params.top_k for r in reqs])
        put(self._topp, [r.params.top_p for r in reqs])
        put(self._eos, [a[3] for a in armed])
        put(self._seeds, [self._eff_seed(r) & prng.M32 for r in reqs])
        put(self._gens, [1] * len(armed))            # the first token was index 0
        if self.spec is not None:
            put(self._keff, [self._eff_keff(r) for r in reqs])
            put(self._match, [r.params.spec_accept == "match" for r in reqs])
            rows = [spec_mod.seed_history(r.prompt, a[2], self.max_seq) for r, a in
                    zip(reqs, armed)]
            put(self._hist, np.stack([row for row, _ in rows]))
            put(self._hlen, [n for _, n in rows])

    def _release_slot(self, slot: int) -> None:
        self.kv.release(slot)
        self._running.pop(slot)
        self._active_host[slot] = False

    def _stochastic(self) -> tuple[bool, bool]:
        """(some running request samples, some sampled one uses "reject"):
        the draw and the rejection pipeline run only when a lane needs
        them, so an all-greedy pool pays a plain argmax."""
        sampled = [r for r in self._running.values() if r.params.temperature > 0]
        return bool(sampled), any(r.params.spec_accept == "reject" for r in sampled)

    def _draw(self, logits: torch.Tensor, gens: torch.Tensor, stochastic: bool):
        """Each slot's next token from its (B, V) f32 logits at token index
        `gens`: its own sampling parameters, or argmax for an all-greedy
        pool."""
        if not stochastic:
            return sampler.greedy(logits)
        keys = sampler.fold_keys(self._key, self._seeds, gens)
        return sampler.sample(keys, logits, self._temp, self._topk, self._topp)

    def _chunk_body(self, stochastic: bool):
        """`decode_chunk` decode steps over the whole slot pool, into
        `_emits` (chunk, slots), -1 where a lane was inactive.  Per step:
        draw where active (`_draw`), count the token index and the budget,
        stop a lane at its EOS or when its budget is spent.  The lane state
        moves on in place."""
        def body():
            tok, active, rem, gens = self._tok, self._active, self._rem, self._gens
            for i in range(self.decode_chunk):
                logits = zoo.decode_step(self.params, self.cfg, tok, self.kv.cache)
                nxt = self._draw(logits[:, : self._vocab].float(), gens, stochastic)
                self._emits[i].copy_(torch.where(active, nxt, -1))
                step = active.to(torch.int32)
                gens = gens + step
                rem = rem - step
                hit_eos = active & (self._eos >= 0) & (nxt == self._eos)
                active = active & ~hit_eos & (rem > 0)
                tok = torch.where(active, nxt, tok[:, 0])[:, None]
            self._store((tok, active, rem, gens))
        return body

    def _store(self, state: tuple) -> None:
        """Write a (tok, active, rem, gens[, hist, hlen]) lane state back
        into the scheduler's own storage."""
        for dst, src in zip((self._tok, self._active, self._rem, self._gens, self._hist,
                             self._hlen), state):
            dst.copy_(src)

    def _decode_and_harvest(self, finished: list[Request]) -> None:
        if not self._active_host.any():
            return
        if self.spec is not None:
            self._spec_decode_and_harvest(finished)
            return
        t0 = time.perf_counter()
        stochastic = self._stochastic()[0]
        self.graphs.run(("chunk", stochastic), self._chunk_body(stochastic))
        fetched = self._fetch(self._emits, self._active)
        self._overlap_admit(finished)        # chunk in flight: prepare admission
        emits, active_np = fetched()         # the chunk's one sync
        t1 = time.perf_counter()
        self.stats.decode_seconds += t1 - t0
        self.stats.decode_steps += self.decode_chunk
        self.stats.step_time_hist.observe((t1 - t0) / self.decode_chunk,
                                          n=self.decode_chunk)
        for slot, req in list(self._running.items()):
            col = emits[:, slot]
            new = col[col >= 0].tolist()
            req.tokens.extend(new)
            self.stats.tokens_generated += len(new)
            self.stats.decode_tokens += len(new)
            # slot_len = actual cache rows: prompt rows + one row per
            # decode-emitted token (the newest token's row lands on the
            # step that feeds it back)
            self._grow(slot, len(new))
            if not active_np[slot]:
                self._finish(req, finished)
                self._release_slot(slot)

    def _grow(self, slot: int, n: int) -> None:
        """Count `n` committed cache rows for `slot`, within its reservation."""
        self.kv.slot_len[slot] += n
        cap = self.kv.slot_capacity(slot)
        if self.kv.slot_len[slot] > cap:
            raise RuntimeError(f"slot {slot}: {self.kv.slot_len[slot]} cache rows exceed "
                               f"the {cap}-row reservation")

    # -- speculative decoding -----------------------------------------------

    def _lanes(self) -> tuple:
        """The lane state a verify reads: (tok, active, rem, gens, hist, hlen)."""
        return self._tok, self._active, self._rem, self._gens, self._hist, self._hlen

    def _verify(self, lanes: tuple, drafts: torch.Tensor, stochastic: bool,
                any_reject: bool):
        """One verify forward over [pending token, drafts] for every slot,
        then acceptance and the history append.  The cache keeps all k + 1
        rows until the caller's rollback.  Returns (pos0, undo, emits, cnt,
        judged, the lanes' next state)."""
        tok, active, rem, gens, hist, hlen = lanes
        pos0 = zoo.cache_position(self.cfg, self.kv.cache)
        logits, undo = zoo.verify_step(self.params, self.cfg, torch.cat([tok, drafts], dim=1),
                                       self.kv.cache)
        emits, cnt, judged, tok, active, rem, gens = spec_mod.acceptance(
            logits[..., : self._vocab].float(), drafts, tok, base_key=self._key,
            seeds=self._seeds, gens=gens, temp=self._temp, topk=self._topk,
            topp=self._topp, eos=self._eos, rem=rem, active=active, k_eff=self._keff,
            match=self._match, stochastic=stochastic, any_reject=any_reject)
        hist, hlen = spec_mod.append_history(hist, hlen, emits, cnt)
        return pos0, undo, emits, cnt, judged, (tok, active, rem, gens, hist, hlen)

    def _spec_fused_body(self, stochastic: bool, any_reject: bool):
        """Every cycle of a step on the device (the reference's fused scan):
        n-gram proposal, verify, acceptance, history append and
        `zoo.cache_rollback`, into `_spec_out`; the lanes move on in place."""
        s_width, out = self.spec.k + 1, self._spec_out

        def body():
            lanes = self._lanes()
            for c in range(self._spec_cycles):
                tok, _, _, _, hist, hlen = lanes
                drafts = spec_mod.ngram_propose(hist, hlen, tok, self.spec.k,
                                                n=self.drafter.n)
                pos0, undo, emits, cnt, judged, lanes = self._verify(
                    lanes, drafts, stochastic, any_reject)
                zoo.cache_rollback(self.cfg, self.kv.cache, undo, pos0, cnt, s_width)
                for name, val in (("emits", emits), ("cnt", cnt), ("judged", judged)):
                    out[name][c].copy_(val)
            self._store(lanes)
        return body

    def _propose_body(self):
        """The n-gram drafter's (slots, k) proposals into `_drafts`."""
        self._drafts.copy_(spec_mod.ngram_propose(self._hist, self._hlen, self._tok,
                                                  self.spec.k, n=self.drafter.n))

    def _verify_body(self, stochastic: bool, any_reject: bool):
        """One verify of `_drafts` with acceptance and history, into
        `_verify_out`; the lanes move on in place."""
        def body():
            pos0, _, emits, cnt, judged, lanes = self._verify(self._lanes(), self._drafts,
                                                              stochastic, any_reject)
            for name, val in (("pos0", pos0), ("emits", emits), ("cnt", cnt),
                              ("judged", judged)):
                self._verify_out[name].copy_(val)
            self._store(lanes)
        return body

    def _spec_cycles_run(self, stochastic: bool, any_reject: bool) -> None:
        """Every cycle of a step into `_spec_out`.  Fused: one program.
        Unfused: per cycle the proposal and the verify as programs of their
        own (the drafts' host time kept apart) and the rollback through
        `SlotKVCache.rollback`, as the reference dispatches them."""
        if self.spec.fused:
            self.graphs.run(("spec", stochastic, any_reject),
                            self._spec_fused_body(stochastic, any_reject))
            self.kv.note_scan_rollbacks(self._spec_cycles)
            return
        vout = self._verify_out
        for c in range(self._spec_cycles):
            td0 = time.perf_counter()
            self.graphs.run(("propose",), self._propose_body)
            self.stats.spec_draft_seconds += time.perf_counter() - td0
            self.graphs.run(("verify", stochastic, any_reject),
                            self._verify_body(stochastic, any_reject))
            self.kv.rollback(vout["pos0"], vout["cnt"], self.spec.k + 1)
            for name in ("emits", "cnt", "judged"):
                self._spec_out[name][c].copy_(vout[name])

    def _spec_decode_and_harvest(self, finished: list[Request]) -> None:
        """Draft/verify decode: each cycle proposes k drafts per slot,
        verifies them with one forward, keeps the accepted prefix and
        sweeps the rejected rows — up to k+1 tokens per slot per packed
        weight read.  One host sync per scheduler step."""
        cycles = self._spec_cycles
        t0 = time.perf_counter()
        self._spec_cycles_run(*self._stochastic())
        out = self._spec_out
        fetched = self._fetch(out["emits"], out["cnt"], out["judged"], self._active)
        self._overlap_admit(finished)        # cycles in flight: prepare admission
        # (cycles, slots, k+1), (cycles, slots) x 2, (slots,): the one sync
        emits_np, cnts_np, judged_np, active_np = fetched()
        t1 = time.perf_counter()
        st = self.stats
        st.decode_seconds += t1 - t0
        st.decode_steps += cycles
        st.verify_steps += cycles
        st.step_time_hist.observe((t1 - t0) / cycles, n=cycles)
        for slot, req in list(self._running.items()):
            cnt = cnts_np[:, slot]
            rode = int((cnt > 0).sum())
            col = emits_np[:, slot, :].reshape(-1)
            new = col[col >= 0].tolist()
            # drafts whose verdict reached the stream (accepted ones, and an
            # emitted correction's rejected one); drafts past an EOS or
            # budget cut were never judgeable
            proposed = int(judged_np[:, slot].sum())
            accepted = int(np.maximum(cnt - 1, 0).sum())
            req.tokens.extend(new)
            req.spec_verify_steps += rode
            req.spec_proposed += proposed
            req.spec_accepted += accepted
            st.lane_verify_steps += rode
            st.draft_proposed += proposed
            st.draft_accepted += accepted
            st.tokens_generated += len(new)
            st.decode_tokens += len(new)
            # one committed cache row per emitted token, as in the chunk
            # loop (the rollback already swept the rejected rows)
            self._grow(slot, len(new))
            if not active_np[slot]:
                self._finish(req, finished)
                self._release_slot(slot)

    @torch.no_grad()
    def step(self) -> list[Request]:
        """One scheduler iteration: admit, one decode chunk, harvest.
        Returns requests that finished this step.

        With async admission the groups prepared under the previous chunk
        commit first; the chunk then dispatches and `_admit` prepares the
        next groups while it runs.  An idle pool has nothing to overlap
        with: it admits and commits synchronously, so fresh slots decode
        this very step."""
        finished: list[Request] = []
        if self.async_admission:
            self._commit_admissions(finished)
        if not self.async_admission or not self._active_host.any():
            self._admit(finished)
        self._decode_and_harvest(finished)
        return finished

    def run(self, requests: list[Request], max_steps: int = 1_000_000) -> list[Request]:
        """Drive a workload to completion. `Request.arrival` is the
        scheduler step at which a request reaches the queue."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        done: list[Request] = []
        t = 0
        while pending or self.n_pending:
            while pending and pending[0].arrival <= t:
                self.submit(pending.pop(0))
            done.extend(self.step())
            t += 1
            if t > max_steps:
                raise RuntimeError("scheduler did not converge")
        return done
