"""Continuous-batching scheduler (port of `repro.serve.scheduler`, the
synchronous path).

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
     chunk (the reference runs the chunk as one jitted `lax.scan`);
  3. harvest — emitted tokens are appended to their requests; finished
     slots are reset and returned to the free list.

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
prefill, async admission, telemetry, the flight recorder and multi-device
meshes.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.core.types import PackedHiNM
from repro_torch.device import resolve_device
from repro_torch.models import zoo
from repro_torch.serve import prng, sampler
from repro_torch.serve import spec as spec_mod
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
                 device="cuda"):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown admission policy {policy!r}")
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
        self._queue: collections.deque[Request] = collections.deque()
        self._running: dict[int, Request] = {}
        self._active_host = np.zeros((max_slots,), bool)
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

    def _reset_state(self, rng_seed: int) -> None:
        s, dev = self.max_slots, self.device
        self._tok = torch.zeros((s, 1), dtype=torch.int32, device=dev)
        self._active = torch.zeros((s,), dtype=torch.bool, device=dev)
        self._rem = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._temp = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._topp = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._eos = torch.full((s,), -1, dtype=torch.int32, device=dev)
        self._seeds = torch.zeros((s,), dtype=torch.int64, device=dev)
        self._gens = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._keff = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._match = torch.ones((s,), dtype=torch.bool, device=dev)
        # per-slot token history (prompt + emitted): the n-gram drafter's
        # lookup corpus, sized for prompt + max_new (max_seq bounds both)
        self._hist = torch.zeros((s, self.max_seq), dtype=torch.int32, device=dev)
        self._hlen = torch.zeros((s,), dtype=torch.int32, device=dev)
        # base PRNG key, never split: every draw folds in (request seed,
        # token index), so streams are reproducible per request
        self._key = prng.PRNGKey(rng_seed, device=dev)
        self._active_host[:] = False

    def reset(self, rng_seed: int = 0) -> None:
        """Drop all queued/running requests and restore pristine state."""
        self._queue.clear()
        self._running.clear()
        self.kv.reset_all()
        self._reset_state(rng_seed)
        self.stats = ServeStats(0.0, 0.0, 0, self.stats.packed_param_bytes,
                                self.stats.dense_param_bytes)

    # -- request lifecycle --------------------------------------------------

    @property
    def n_pending(self) -> int:
        return len(self._queue) + len(self._running)

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
        while self._queue and self.kv.n_free > 0:
            # group the queue head by prompt-length bucket: one batched
            # prefill per group (one compiled shape per bucket in the
            # reference; here it keeps the prefill batch wide)
            def sig(r):
                return self._bucket_len(len(r.prompt))

            head_reserve = self._reserve_rows(self._queue[0])
            if self.kv.paged and self.kv.pages_needed(head_reserve) > self.kv.n_free_pages:
                return  # FIFO head waits for releases, no starvation
            pages_left = self.kv.n_free_pages
            if self.kv.paged:
                pages_left -= self.kv.pages_needed(head_reserve)
            group = [self._queue.popleft()]
            while (self._queue and len(group) < self.kv.n_free
                   and sig(self._queue[0]) == sig(group[0])):
                if self.kv.paged:
                    need = self.kv.pages_needed(self._reserve_rows(self._queue[0]))
                    if need > pages_left:
                        break
                    pages_left -= need
                group.append(self._queue.popleft())
            self._admit_group(group, finished)

    @torch.no_grad()
    def _admit_group(self, group: list[Request], finished: list[Request]) -> None:
        """Prefill an admission group, draw its first tokens (token index 0
        of each request's stream; one host sync per group = TTFT) and arm
        its slots."""
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
        rows = np.zeros((k_b,), np.int32)
        padded = [group[min(i, k - 1)] for i in range(k_b)]
        for i, r in enumerate(padded):
            tokens[i, : len(r.prompt)] = r.prompt
            rows[i] = len(r.prompt)
        n_rows = torch.from_numpy(rows).to(self.device)
        tokens = torch.from_numpy(tokens).to(self.device)
        cache_k = self.kv.template(k_b)
        last = zoo.prefill(self.params, self.cfg, tokens, cache_k, n_rows=n_rows)
        logits = zoo.logits_fn(self.params, self.cfg, last)[:, : self._vocab].float()
        if any(r.params.temperature > 0 for r in group):
            def dev(vals, dtype):
                return torch.tensor(vals, dtype=dtype, device=self.device)

            seeds = dev([self._eff_seed(r) & prng.M32 for r in padded], torch.int64)
            keys = sampler.fold_keys(self._key, seeds, torch.zeros_like(seeds))
            first = sampler.sample(
                keys, logits, dev([r.params.temperature for r in padded], torch.float32),
                dev([r.params.top_k for r in padded], torch.int32),
                dev([r.params.top_p for r in padded], torch.float32))
        else:
            first = sampler.greedy(logits)
        first_np = first.cpu().numpy()   # one sync per group
        now = time.perf_counter()
        self.stats.prefill_rows += sum(len(r.prompt) for r in group)
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
        self.stats.prefill_seconds += time.perf_counter() - t0

    def _arm(self, armed: list[tuple]) -> None:
        """Arm the per-slot decode state of freshly admitted slots, one copy
        per state vector: (slot, request, first token, effective EOS)."""
        idx = torch.tensor([a[0] for a in armed], dtype=torch.int64, device=self.device)

        def put(dst, vals):
            dst[idx] = torch.tensor(vals, dtype=dst.dtype).to(self.device)

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

    @torch.no_grad()
    def _run_chunk(self, stochastic: bool) -> torch.Tensor:
        """`decode_chunk` decode steps over the whole slot pool, on the
        device; returns the (chunk, slots) emitted tokens (-1 where a lane
        was inactive).  Per step: draw where active (`_draw`), count the
        token index and the budget, stop a lane at its EOS or when its
        budget is spent."""
        emits = []
        tok, active, rem, gens = self._tok, self._active, self._rem, self._gens
        for _ in range(self.decode_chunk):
            logits = zoo.decode_step(self.params, self.cfg, tok, self.kv.cache)
            nxt = self._draw(logits[:, : self._vocab].float(), gens, stochastic)
            emits.append(torch.where(active, nxt, -1))
            step = active.to(torch.int32)
            gens = gens + step
            rem = rem - step
            hit_eos = active & (self._eos >= 0) & (nxt == self._eos)
            active = active & ~hit_eos & (rem > 0)
            tok = torch.where(active, nxt, tok[:, 0])[:, None]
        self._tok, self._active, self._rem, self._gens = tok, active, rem, gens
        return torch.stack(emits)

    def _decode_and_harvest(self, finished: list[Request]) -> None:
        if not self._active_host.any():
            return
        if self.spec is not None:
            self._spec_decode_and_harvest(finished)
            return
        t0 = time.perf_counter()
        emits = self._run_chunk(self._stochastic()[0]).cpu().numpy()  # one sync
        active_np = self._active.cpu().numpy()
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

    def _propose(self) -> torch.Tensor:
        """The n-gram drafter's (slots, k) proposals from each slot's history."""
        return spec_mod.ngram_propose(self._hist, self._hlen, self._tok, self.spec.k,
                                      n=self.drafter.n)

    @torch.no_grad()
    def _verify(self, drafts: torch.Tensor, stochastic: bool, any_reject: bool):
        """One verify forward over [pending token, drafts] for every slot,
        then acceptance and the history append; the per-slot state moves on
        by the emitted tokens.  The cache keeps all k + 1 rows until the
        caller's rollback.  Returns (pos0, emits, cnt, judged, undo)."""
        pos0 = zoo.cache_position(self.cfg, self.kv.cache)
        tokens = torch.cat([self._tok, drafts], dim=1)
        logits, undo = zoo.verify_step(self.params, self.cfg, tokens, self.kv.cache)
        (emits, cnt, judged, self._tok, self._active, self._rem,
         self._gens) = spec_mod.acceptance(
            logits[..., : self._vocab].float(), drafts, self._tok, base_key=self._key,
            seeds=self._seeds, gens=self._gens, temp=self._temp, topk=self._topk,
            topp=self._topp, eos=self._eos, rem=self._rem, active=self._active,
            k_eff=self._keff, match=self._match, stochastic=stochastic,
            any_reject=any_reject)
        self._hist, self._hlen = spec_mod.append_history(self._hist, self._hlen, emits, cnt)
        return pos0, emits, cnt, judged, undo

    def _spec_cycles_run(self, stochastic: bool, any_reject: bool):
        """Every cycle of a step: draft, verify, accept, rollback.  Fused:
        the rollback is `zoo.cache_rollback` inside each cycle, nothing
        leaves the device until the caller's one sync.  Unfused: the same
        cycle as separate calls, the rollback through
        `SlotKVCache.rollback`, the drafts' host time kept apart.  Returns
        the stacked (cycles, slots, k+1) emits, (cycles, slots) counts and
        judged drafts."""
        s_width = self.spec.k + 1
        out = []
        for _ in range(self._spec_cycles):
            td0 = time.perf_counter()
            drafts = self._propose()
            if not self.spec.fused:
                self.stats.spec_draft_seconds += time.perf_counter() - td0
            pos0, emits, cnt, judged, undo = self._verify(drafts, stochastic, any_reject)
            if self.spec.fused:
                zoo.cache_rollback(self.cfg, self.kv.cache, undo, pos0, cnt, s_width)
            else:
                self.kv.rollback(pos0, cnt, s_width, undo=undo)
            out.append((emits, cnt, judged))
        if self.spec.fused:
            self.kv.note_scan_rollbacks(self._spec_cycles)
        return tuple(torch.stack(x) for x in zip(*out))

    def _spec_decode_and_harvest(self, finished: list[Request]) -> None:
        """Draft/verify decode: each cycle proposes k drafts per slot,
        verifies them with one forward, keeps the accepted prefix and
        sweeps the rejected rows — up to k+1 tokens per slot per packed
        weight read.  One host sync per scheduler step."""
        cycles = self._spec_cycles
        t0 = time.perf_counter()
        emits, cnts, judged = self._spec_cycles_run(*self._stochastic())
        emits_np = emits.cpu().numpy()     # (cycles, slots, k+1) — one sync
        cnts_np = cnts.cpu().numpy()       # (cycles, slots)
        judged_np = judged.cpu().numpy()
        active_np = self._active.cpu().numpy()
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

    def step(self) -> list[Request]:
        """One scheduler iteration: admit, one decode chunk, harvest.
        Returns requests that finished this step."""
        finished: list[Request] = []
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
