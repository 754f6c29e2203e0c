"""Continuous-batching scheduler (port of `repro.serve.scheduler`, the
synchronous path).

The decode batch is a fixed-width pool of request slots (`SlotKVCache`).
Every scheduler step:

  1. admission — queued requests are prefilled, grouped by prompt-length
     bucket and padded with sentinel-masked rows, and inserted into free
     slots; a paged pool also gates admission on free KV pages.
     `policy="static"` instead gang-admits only when the pool is idle;
  2. decode — a chunk of `decode_chunk` decode steps with greedy sampling
     and per-slot EOS / length early-exit masking, all on the device; the
     only host transfer is the (chunk, slots) emitted-token matrix once per
     chunk (the reference runs the chunk as one jitted `lax.scan`);
  3. harvest — emitted tokens are appended to their requests; finished
     slots are reset and returned to the free list.

Inactive lanes keep stepping inside a chunk (fixed-shape batch); their
cache writes land under their own lane's `kpos` mask or on the scratch
page, and are wiped by the slot reset on reuse.

What waits for later slices: sampled requests (`temperature > 0` raises),
speculative decoding, prefix sharing, chunked prefill, async admission,
telemetry, the flight recorder and multi-device meshes.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.core.types import PackedHiNM
from repro_torch.device import resolve_device
from repro_torch.models import zoo
from repro_torch.serve import sampler
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
                 decode_chunk: int = 8, policy: str = "continuous",
                 page: int | None = 64, n_pages: int | str | None = "auto",
                 packed: str = "auto", device="cuda"):
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
        self.kv = SlotKVCache(cfg, max_slots, max_seq, page=page, n_pages=n_pages,
                              device=self.device)
        self._queue: collections.deque[Request] = collections.deque()
        self._running: dict[int, Request] = {}
        self._active_host = np.zeros((max_slots,), bool)
        self._reset_state()
        pb, db = param_bytes(params)
        self.stats = ServeStats(0.0, 0.0, 0, pb, db)

    def _reset_state(self) -> None:
        s, dev = self.max_slots, self.device
        self._tok = torch.zeros((s, 1), dtype=torch.int32, device=dev)
        self._active = torch.zeros((s,), dtype=torch.bool, device=dev)
        self._rem = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._eos = torch.full((s,), -1, dtype=torch.int32, device=dev)
        self._active_host[:] = False

    def reset(self) -> None:
        """Drop all queued/running requests and restore pristine state."""
        self._queue.clear()
        self._running.clear()
        self.kv.reset_all()
        self._reset_state()
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
        if req.params.temperature > 0:
            raise ValueError(
                f"request {req.rid}: sampled decoding (temperature > 0) is not "
                "ported yet — the PRNG decision is open in ROADMAP.md (Queue 1 "
                "item 5); use temperature 0 (greedy)")
        rows = len(req.prompt)
        if rows + req.params.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid}: {rows} prompt rows + max_new_tokens "
                f"{req.params.max_new_tokens} exceeds max_seq {self.max_seq}")
        if (self.kv.paged and self.kv.pages_needed(self._reserve_rows(req))
                > self.kv.n_alloc_pages):
            raise ValueError(f"request {req.rid}: needs more KV pages than the "
                             "pool allocates — raise n_pages")
        req.state = RequestState.QUEUED
        req.submit_time = time.perf_counter()
        self._queue.append(req)

    def _eff_eos(self, req: Request) -> int:
        if req.params.eos_id is not None:
            return req.params.eos_id if 0 <= req.params.eos_id < self._vocab else -1
        return self.default_eos

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
        """Prefill an admission group, sample its first tokens (one host
        sync per group = TTFT) and arm its slots."""
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
        for i in range(k_b):
            r = group[min(i, k - 1)]
            tokens[i, : len(r.prompt)] = r.prompt
            rows[i] = len(r.prompt)
        n_rows = torch.from_numpy(rows).to(self.device)
        tokens = torch.from_numpy(tokens).to(self.device)
        cache_k = self.kv.template(k_b)
        last = zoo.prefill(self.params, self.cfg, tokens, cache_k, n_rows=n_rows)
        logits = zoo.logits_fn(self.params, self.cfg, last)[:, : self._vocab].float()
        first_np = sampler.greedy(logits).cpu().numpy()   # one sync per group
        now = time.perf_counter()
        self.stats.prefill_rows += sum(len(r.prompt) for r in group)
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
            self._tok[slot, 0] = first_i
            self._active[slot] = True
            self._rem[slot] = p.max_new_tokens - 1
            self._eos[slot] = eos
            self._active_host[slot] = True
            req.state = RequestState.DECODING
            req.slot = slot
            self._running[slot] = req
        self.stats.prefill_seconds += time.perf_counter() - t0

    def _release_slot(self, slot: int) -> None:
        self.kv.release(slot)
        self._running.pop(slot)
        self._active_host[slot] = False

    @torch.no_grad()
    def _run_chunk(self) -> torch.Tensor:
        """`decode_chunk` greedy decode steps over the whole slot pool, on
        the device; returns the (chunk, slots) emitted tokens (-1 where a
        lane was inactive).  Per step: emit where active, count down the
        budget, stop a lane at its EOS or when its budget is spent."""
        emits = []
        tok, active, rem = self._tok, self._active, self._rem
        for _ in range(self.decode_chunk):
            logits = zoo.decode_step(self.params, self.cfg, tok, self.kv.cache)
            nxt = sampler.greedy(logits[:, : self._vocab].float())
            emits.append(torch.where(active, nxt, -1))
            rem = rem - active.to(torch.int32)
            hit_eos = active & (self._eos >= 0) & (nxt == self._eos)
            active = active & ~hit_eos & (rem > 0)
            tok = torch.where(active, nxt, tok[:, 0])[:, None]
        self._tok, self._active, self._rem = tok, active, rem
        return torch.stack(emits)

    def _decode_and_harvest(self, finished: list[Request]) -> None:
        if not self._active_host.any():
            return
        t0 = time.perf_counter()
        emits = self._run_chunk().cpu().numpy()   # (chunk, slots) — one sync
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
            self.kv.slot_len[slot] += len(new)
            cap = self.kv.slot_capacity(slot)
            if self.kv.slot_len[slot] > cap:
                raise RuntimeError(
                    f"slot {slot}: {self.kv.slot_len[slot]} cache rows exceed "
                    f"the {cap}-row reservation")
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
