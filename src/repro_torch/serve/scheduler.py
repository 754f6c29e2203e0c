"""Continuous-batching scheduler (port of `repro.serve.scheduler`).

The decode batch is a fixed-width pool of request slots (`SlotKVCache`).
Every scheduler step:

  1. admission — queued requests are prefilled, grouped by prompt-length
     bucket and padded with sentinel-masked rows (`bucket`; a recurrent
     family, whose state would integrate padded rows, groups by exact
     length and pads nothing), and inserted into free slots; a paged pool
     also gates admission on free KV pages.
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
instead (`serve/spec`): a drafter proposes `k` tokens per slot, one
multi-token verify forward scores them all, and the pool keeps the
accepted rows while sweeping the rejected ones.  Greedy and "match"-mode
sampled requests emit exactly the non-speculative stream.  The n-gram
drafter looks the proposals up in each slot's token history; the model
drafter (a paired small model, `ModelDrafter`) runs k + 1 greedy decode
steps in its own stripe pool, which is prefilled with the same prompts at
admission and rolled back with the target's accept count, so both pools
always hold the same committed tokens.

With prefix sharing on (`prefix_share`, "auto": on for a paged pool of a
prefix-sharing family under the continuous policy, as the reference's),
admission first walks a host-side radix index over token prefixes
(`serve/prefix`): full pages another request already cached are mapped
into the new slot's block table (a reference more, no K/V movement), a
divergent tail page is copied (copy-on-write), and only the unshared
suffix is prefilled, through `zoo.extend_step`, the multi-token decode
write path the verify takes.  `prefill_chunk=N` also cuts long suffixes
into N-row chunks advanced one per scheduler step between decode chunks
(the decode chunk sweeps the mid-prefill slots' junk rows, as after a
rejected speculation).  The extension program is a captured graph too,
keyed (width bucket, sample, stochastic) as the reference's jit; mapping,
copy-on-write and the eviction sweeps are eager writes between replays.

Observability, as the reference threads it: `telemetry=` (serve/telemetry)
keeps the registry's counters always (prefill programs built, prefix hit
tokens, chunks, overlap admissions, spec dispatches) and, when enabled,
times admission, prefill, decode and the host gap into histograms and
records request-lifecycle spans, all from host clocks at the sync points
the scheduler already has; `flightrec=` (serve/flightrec) records every
admission, page, prefix, spec and dispatch decision as an event built
from host state, for replay and first-divergence diffs.  Neither adds a
sync, and nothing of theirs runs inside a captured body: a body runs only
when its program is built, so per-step instruments sit around the replay.

Frontend-stub requests (`Request.embeds`, (P, D)): a vlm's patch rows go
before the prompt and count as cache rows (bucket, page budget,
`max_seq`); an encoder-decoder's frames feed its encoder, whose output
each slot keeps at the pool's `t_enc` (`cache_kw={"t_enc": ...}`).
Admission groups by (bucket, embeds shape), one prefill program per
(bucket, width, stochastic, embeds shape); embeds requests never take the
extension path nor register in the prefix index.

A recurrent family (xlstm) cannot bucket: its state would integrate the
padded rows.  Its prompts group by exact length, a group's width is its
request count, and a prefill program is one per (exact length, width,
stochastic); its prefill template's state is reset to pristine before
each use (`zoo.rewind_cache`).  It has no pages (a requested page falls
back to stripes), no speculative verify and no prefix sharing.

The hybrid family (recurrentgemma) groups by exact length too (its
RG-LRU state), and so does any windowed config.  Its attention stacks
keep a ring of `window` rows a slot, paged like any other pool: a slot
reserves pages for at most the ring (`SlotKVCache.pages_needed`), and a
prompt longer than the ring is rolled into it at prefill.  Its verify is
sequential (S decode steps with undo snapshots, `zoo.verify_step`): the
fused loop rolls back from the snapshots in its own body, the unfused
chain from the verify program's static `_verify_undo` buffers.  It has
no prefix sharing.

With ``mesh=`` (a `DeviceMesh`, one process per rank, every rank running
this host loop on the same requests) the same loop runs sharded, as the
reference's.  The params are replicated (broadcast from rank 0), and so
is the pool's storage (`SlotKVCache(mesh=)`: its page ids are drawn from
one free list a dp rank, as the reference's page-sharded pool draws them),
so every program and K2 run over the whole pool as off a mesh.  The decode
chunk runs data-parallel: each dp rank steps its own slots
(`data_parallel`) and draws their tokens, and each step's next tokens are
all-gathered, so every rank's host sees the whole batch; prefill, the
speculative programs and the extension run the whole batch on every rank.
Every host decision (admission, pages, harvest) rests on host state alone
— the requests, the tokens, the page lists — never on a clock or an
event's completion, so the ranks decide alike.  The programs hold
collectives and run eagerly (``serve_eager_programs{reason="mesh"}``
counts them; the flight ``config`` event says ``graphs: "eager"``).  The
reference defers K2 to its gather path on a page-sharded pool, which its
kernel cannot walk; the port's pool is whole on every rank, so nothing is
deferred for it.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from repro_torch import perf_knobs
from repro_torch import tree as T
from repro_torch.core.types import PackedHiNM
from repro_torch.device import resolve_device, to_device
from repro_torch.distributed import collectives, sharding
from repro_torch.models import zoo
from repro_torch.serve import prng, sampler
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.flightrec import resolve_flightrec
from repro_torch.serve.graphs import GraphCache
from repro_torch.serve.kv import SlotKVCache
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.request import Request, RequestState, ServeStats
from repro_torch.serve.telemetry import resolve_telemetry


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


def _broadcast_params(model) -> None:
    """Every tensor of `model` (packed weights' fields included) from rank
    0, in place: the replicated params of a sharded scheduler."""
    import torch.distributed as dist

    for mod in model.modules():
        for t in mod._buffers.values():
            if t is not None:
                dist.broadcast(t, src=0)
        w = mod.__dict__.get("w")
        if isinstance(w, PackedHiNM):
            for t in (w.vals, w.vec_idx, w.nm_idx):
                dist.broadcast(t, src=0)


class Scheduler:
    def __init__(self, cfg, params, max_slots: int = 4, max_seq: int = 512,
                 decode_chunk: int = 8, rng_seed: int = 0, policy: str = "continuous",
                 page: int | None = 64, n_pages: int | str | None = "auto",
                 spec: spec_mod.SpecConfig | None = None, packed: str = "auto",
                 prefix_share: bool | str = "auto", prefill_chunk: int | None = None,
                 async_admission: bool | str = "auto", device="cuda", telemetry=None,
                 flightrec=None, cache_kw: dict | None = None, bucket: bool | None = None,
                 mesh=None):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if async_admission == "auto":
            async_admission = policy == "continuous"
        if async_admission and policy != "continuous":
            raise ValueError("async admission requires the continuous admission policy "
                             "(static gang admission is the synchronous baseline)")
        if packed not in ("auto", "pack"):
            raise ValueError(f"unknown packed-weights mode {packed!r}")
        # prompt-length bucketing: pad admission prefill to power-of-two
        # buckets (one program per bucket, not per distinct prompt length).
        # Off for a recurrent family (padded rows would enter the state)
        # and on a windowed config (the stripe's ring roll takes real
        # positions in every prefill row), whose groups share an exact
        # length instead
        can_bucket = zoo.supports_bucketed_prefill(cfg) and not cfg.window
        if bucket and not can_bucket:
            raise ValueError(f"{cfg.family!r} prefill cannot be length-bucketed")
        self.bucket = can_bucket if bucket is None else bool(bucket)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            import torch.distributed as dist

            if (self.device.type == "cuda") != (dist.get_backend() == "nccl"):
                raise ValueError(f"a {self.device.type} scheduler on a "
                                 f"{dist.get_backend()!r} group: a CUDA mesh runs on NCCL, "
                                 "a CPU one on gloo")
        # observability bundle (serve/telemetry): None/"auto" defers to
        # KNOBS.telemetry (off by default).  The registry is live either
        # way: the instruments counted per program built or per decision
        # cost nothing per step; `enabled` gates the wall-clock histograms
        # and the request spans
        self.telemetry = resolve_telemetry(telemetry)
        # flight recorder (serve/flightrec): off by default; True builds a
        # fresh recorder, an instance is shared as it is.  Its Chrome-trace
        # instants engage only when telemetry records spans anyway
        self.flight = resolve_flightrec(
            flightrec, tracer=self.telemetry.tracer if self.telemetry.enabled else None)
        m = self.telemetry.registry
        self._m_prefill_traces = m.counter("serve_prefill_traces")
        self._m_admit_wait = m.histogram("serve_admission_wait_seconds")
        self._m_step = m.histogram("serve_decode_step_seconds")
        self._m_host_gap = m.histogram("serve_host_gap_seconds")
        self._m_spec_draft = m.histogram("serve_spec_draft_seconds")
        self._m_spec_verify = m.histogram("serve_spec_verify_seconds")
        self._m_spec_accept = m.histogram("serve_spec_window_acceptance", lo=1e-4,
                                          growth=1.2, n_buckets=50)
        self._m_hit_tokens = m.counter("serve_prefix_hit_tokens")
        self._m_chunks = m.counter("serve_prefill_chunks")
        self._m_evictions = m.counter("serve_prefix_evictions")
        # programs the spec phase launches or replays (the fused loop is one
        # per step, the unfused chain 3 per cycle); admission groups whose
        # prefill was dispatched under a chunk in flight; blocking host syncs
        # issued under a chunk in flight (the async path's canary: 0)
        self._m_spec_dispatch = m.counter("serve_spec_dispatches")
        self._m_overlap_admit = m.counter("serve_overlap_admissions")
        self._m_inflight_syncs = m.counter("serve_inflight_syncs")
        # serve-time weight packing (one-time, here at construction, in
        # place on `params`): "pack" routes every planned q/k/v/o + MLP
        # projection through hinm_spmm; "auto" serves the weights as given
        if packed == "pack":
            params = zoo.pack_params(cfg, params)
        if mesh is not None:
            _broadcast_params(params)
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
        self.draft_kv = None
        if spec is not None:
            self._check_spec(spec, rng_seed)
        self.kv = SlotKVCache(cfg, max_slots, max_seq, page=page, n_pages=n_pages,
                              device=self.device, mesh=mesh, metrics=m, flight=self.flight,
                              **(cache_kw or {}))
        # the decode chunk's lanes on this rank: its slots where the dp ranks
        # divide the pool, every slot (the whole batch on each rank) else
        self._lanes_lo, self._lanes_hi = 0, max_slots
        if mesh is not None:
            i, n = collectives.dp_rank(mesh)
            if max_slots % n == 0:
                self._lanes_lo, self._lanes_hi = i * max_slots // n, (i + 1) * max_slots // n
        # an encoder-decoder's pool keeps each slot's encoder output at the
        # fixed width t_enc (`cache_kw={"t_enc": ...}` sizes it to the
        # workload's frames)
        self._t_enc = (cache_kw or {}).get("t_enc") or max_seq
        # paged-attention backend, resolved once per scheduler; every
        # program runs under it (`_program`).  A stripe pool never reaches
        # the K2 path
        requested = perf_knobs.KNOBS.paged_attn
        defer = None if self.kv.paged else "pool-not-paged"
        self.paged_attn = requested if defer is None else "off"
        if defer is not None:
            m.counter("serve_paged_attn_deferred", labels={"reason": defer}).inc()
        if self.flight is not None:
            self.flight.emit("dispatch", requested=requested, backend=self.paged_attn,
                             defer=defer)
        # prefix sharing and chunked prefill ride the multi-token decode
        # write path (`zoo.extend_step`): a paged pool, a family whose K/V
        # rows are per-(token, position), and the continuous policy.  "auto"
        # turns sharing off quietly where it cannot run; True raises there
        can_extend = (self.kv.paged and zoo.supports_prefix_share(cfg)
                      and policy == "continuous")
        if prefix_share == "auto":
            prefix_share = can_extend
        if prefix_share and not can_extend:
            raise ValueError(
                f"prefix sharing needs a paged pool + a prefix-sharing family under "
                f"continuous admission (family={cfg.family!r}, window={cfg.window}, "
                f"paged={self.kv.paged}, policy={policy!r})")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1 (or None)")
            if not can_extend:
                raise ValueError(
                    f"chunked prefill needs a paged pool + a prefix-sharing family under "
                    f"continuous admission (family={cfg.family!r}, paged={self.kv.paged}, "
                    f"policy={policy!r})")
        self.prefix_share = bool(prefix_share)
        self.prefill_chunk = prefill_chunk
        self.prefix = (PrefixIndex(self.kv.page, flight=self.flight) if self.prefix_share
                       else None)
        # slots mid-extension-prefill: they hold pages but no decode lane
        self._prefilling: dict[int, Request] = {}
        self._extend_io: dict[int, dict] = {}
        # double-buffered admission: groups prepared under an in-flight
        # chunk await their first-token sync, holding the slots and pages
        # they will draw at commit
        self.async_admission = bool(async_admission)
        self._pending_admits: list[tuple] = []
        self._pending_slots = 0
        self._pending_pages = 0
        self._chunk_in_flight = False
        # a sharded scheduler's bodies hold collectives: they run eagerly
        self.graphs = GraphCache(self.device, on_build=self._on_build, eager=mesh is not None)
        if mesh is not None:
            self._m_eager = m.counter("serve_eager_programs", labels={"reason": "mesh"})
        self._prefill_io: dict[tuple, dict] = {}
        self._queue: collections.deque[Request] = collections.deque()
        self._running: dict[int, Request] = {}
        self._active_host = np.zeros((max_slots,), bool)
        self._alloc_state()
        self._reset_state(rng_seed)
        pb, db = param_bytes(params)
        self.stats = ServeStats(0.0, 0.0, 0, pb, db)
        if self.flight is not None:
            # configuration fingerprint: a replay on a scheduler built
            # otherwise diverges here, at its first event
            spec_cfg = None if spec is None else {
                "k": spec.k, "fused": bool(spec.fused), "cycles": self._spec_cycles,
                "drafter": self.drafter.kind}
            extra = {} if mesh is None else {"graphs": "eager"}
            self.flight.emit(
                "config", family=cfg.family, vocab=int(cfg.vocab), max_slots=max_slots,
                max_seq=max_seq, decode_chunk=decode_chunk, policy=policy,
                page=self.kv.page if self.kv.paged else None,
                n_pages=self.kv.n_pages if self.kv.paged else None, bucket=self.bucket,
                packed=packed, paged_attn=self.paged_attn, prefix_share=self.prefix_share,
                prefill_chunk=self.prefill_chunk, async_admission=self.async_admission,
                rng_seed=rng_seed, sharded=mesh is not None, spec=spec_cfg, **extra)

    def _on_build(self, key) -> None:
        """`GraphCache` is building `key`'s program: a prefill program counts
        in ``serve_prefill_traces`` (the reference counts its traces)."""
        if key[0] == "prefill":
            self._m_prefill_traces.inc()

    def _program(self, key, body) -> None:
        """Run `body` as `key`'s program (`GraphCache.run`) under this
        scheduler's paged-attention backend.  The knob is read when the body
        runs, which is only while a program is built on the card."""
        def run():
            with perf_knobs.knobs(paged_attn=self.paged_attn):
                body()
        if self.mesh is not None:
            self._m_eager.inc()
        self.graphs.run(key, run)

    def _check_spec(self, spec, rng_seed: int) -> None:
        """Validate a SpecConfig, resolve its drafter and the cycle count;
        a model drafter gets its own stripe pool."""
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
        elif d == "model":
            d = spec_mod.ModelDrafter.from_zoo(cfg, rng_seed, device=self.device)
        if getattr(d, "kind", None) not in ("ngram", "model"):
            raise ValueError(f"unknown drafter {d!r}: pass \"ngram\", \"model\", or a "
                             "Drafter instance with kind in ('ngram', 'model')")
        self.drafter = d
        if d.kind == "model":
            # the draft model keeps its own stripe pool, rolled back in
            # lockstep with the target, so both pools always hold the same
            # committed token stream
            if self.mesh is not None:
                _broadcast_params(d.params)
            self.draft_kv = SlotKVCache(d.cfg, self.max_slots, self.max_seq,
                                        device=self.device, mesh=self.mesh,
                                        metrics=self.telemetry.registry,
                                        metrics_labels={"pool": "draft"}, flight=self.flight,
                                        flight_label="draft")

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
        # the lanes a guarded chunk rewinds (slots mid-extension-prefill)
        self._protect = vec(torch.bool)
        if self.spec is not None:
            k1, cyc = self.spec.k + 1, self._spec_cycles
            # the spec loop's stacked results, and one verify's (unfused)
            self._spec_out = {"emits": vec(i32, cyc, s, k1), "cnt": vec(i32, cyc, s),
                              "judged": vec(i32, cyc, s)}
            self._verify_out = {"pos0": vec(i32), "emits": vec(i32, s, k1),
                                "cnt": vec(i32), "judged": vec(i32)}
            # a sequential verifier's undo snapshots (`zoo.verify_step`):
            # allocated by the verify's first, eager run, then written in
            # place by every run and replay, where the rollback reads them
            self._verify_undo = None
            self._drafts = vec(i32, s, self.spec.k)
            # the draft pool's positions before an unfused proposal
            self._draft_pos0 = vec(i32)

    def _reset_state(self, rng_seed: int) -> None:
        for t in (self._tok, self._active, self._rem, self._temp, self._topk, self._topp,
                  self._seeds, self._gens, self._keff, self._hist, self._hlen):
            t.zero_()
        self._eos.fill_(-1)
        self._match.fill_(True)
        self._key.copy_(prng.PRNGKey(rng_seed, device=self.device))
        self._active_host[:] = False
        # the host clock at the last decode sync: the gap until the next
        # dispatch is host time (admission, harvest, Python)
        self._last_sync = None

    def reset(self, rng_seed: int = 0) -> None:
        """Drop all queued/running requests and restore pristine state, in
        the same storage (the captured graphs stay valid)."""
        self._queue.clear()
        self._running.clear()
        self._prefilling.clear()
        self._pending_admits.clear()
        self._pending_slots = 0
        self._pending_pages = 0
        self._chunk_in_flight = False
        if self.prefix is not None:
            self.prefix = PrefixIndex(self.kv.page, flight=self.flight)
        self.kv.reset_all()
        if self.draft_kv is not None:
            self.draft_kv.reset_all()
        self._reset_state(rng_seed)
        self.stats = ServeStats(0.0, 0.0, 0, self.stats.packed_param_bytes,
                                self.stats.dense_param_bytes)

    # -- request lifecycle --------------------------------------------------

    def clear_prefix_cache(self) -> int:
        """Drop every retained prefix (the index's page references).  Pages
        no live slot maps return to the free list at once; shared ones follow
        when their last slot releases.  Returns pages freed now."""
        if self.prefix is None:
            return 0
        return self.prefix.clear(self.kv)

    def metrics_snapshot(self, include_global: bool = True) -> dict:
        """JSON-able snapshot of every instrument this scheduler feeds."""
        return self.telemetry.snapshot(include_global=include_global)

    @property
    def n_pending(self) -> int:
        return (len(self._queue) + len(self._prefilling) + len(self._running)
                + sum(len(rec[0]) for rec in self._pending_admits))

    def _cache_rows(self, req: Request) -> int:
        """Decoder-cache rows this request's prefill fills: a vlm's embeds
        rows go before the prompt's; an encoder-decoder's frames feed the
        encoder (kept apart, in the slot's enc_out) and count for none."""
        extra = 0
        if req.embeds is not None and self.cfg.family != "encdec":
            extra = req.embeds.shape[0]
        return len(req.prompt) + extra

    def _reserve_rows(self, req: Request) -> int:
        """Cache rows this request may legally grow to (page budget)."""
        return self._cache_rows(req) + req.params.max_new_tokens

    def _prompt_len(self, n_tokens: int, extra: int = 0) -> int:
        """The prefill length of a prompt of `n_tokens`: its bucket
        (`_bucket_len`), or the exact length when not bucketing."""
        return self._bucket_len(n_tokens, extra) if self.bucket else n_tokens

    def _bucket_len(self, n_tokens: int, extra: int = 0) -> int:
        """Power-of-two prompt-length bucket (from 8), clamped so the bucket
        plus `extra` rows that are not tokens (a vlm's embeds) still fit the
        prefill stripe."""
        b = 8
        while b < n_tokens:
            b *= 2
        return max(n_tokens, min(b, self.max_seq - extra))

    def submit(self, req: Request) -> None:
        rows = self._cache_rows(req)
        if rows + req.params.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid}: {rows} prompt rows + max_new_tokens "
                f"{req.params.max_new_tokens} exceeds max_seq {self.max_seq}")
        if (self.kv.paged and self.kv.pages_needed(self._reserve_rows(req))
                > self.kv.n_alloc_pages):
            raise ValueError(f"request {req.rid}: needs more KV pages than the "
                             "pool allocates — raise n_pages")
        if (self.cfg.family == "encdec" and req.embeds is not None
                and req.embeds.shape[0] > self._t_enc):
            raise ValueError(f"request {req.rid}: {req.embeds.shape[0]} encoder frames "
                             f"exceed the pool's t_enc {self._t_enc}")
        if req.params.spec_accept not in ("match", "reject"):
            raise ValueError(f"request {req.rid}: unknown spec_accept "
                             f"{req.params.spec_accept!r}")
        req.state = RequestState.QUEUED
        req.submit_time = time.perf_counter()
        self._queue.append(req)
        if self.flight is not None:
            # the whole admission schedule rides in this one event: prompt,
            # sampling parameters, seed, arrival (what `flightrec.replay`
            # rebuilds the workload from)
            p = req.params
            self.flight.emit(
                "submit", rid=req.rid, prompt=[int(t) for t in req.prompt],
                arrival=req.arrival, max_new=p.max_new_tokens,
                temperature=float(p.temperature), top_k=int(p.top_k), top_p=float(p.top_p),
                eos=p.eos_id, seed=p.seed, spec_k=p.spec_k, spec_accept=p.spec_accept,
                embeds=req.embeds is not None)

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
        if self.telemetry.enabled and req.first_token_time:
            # the decode span opened when the lane armed (an abandoned
            # request still exports it, auto-closed); a request finished at
            # its first token never armed one
            open_span = next((sp for sp in reversed(req.spans)
                              if sp.name == "decode" and sp.t1 is None), None)
            if open_span is not None:
                self.telemetry.tracer.end(open_span, req.finish_time, tokens=req.n_generated,
                                          reason=req.finish_reason)
            else:
                self.telemetry.tracer.request_span(
                    req, "decode", req.first_token_time, req.finish_time,
                    tokens=req.n_generated, reason=req.finish_reason)
        if self.flight is not None:
            self.flight.emit("finish", rid=req.rid, reason=req.finish_reason,
                             n=req.n_generated, tokens=list(req.tokens))
        finished.append(req)

    def _extension_plan(self, req: Request):
        """(take the extension path, PrefixMatch or None) for a queued
        request.  A request extends in the pool (pages mapped first, suffix
        prefilled through `zoo.extend_step`) when its prompt hits the prefix
        index (a stripe-scatter insert would overwrite co-owned rows) or
        when chunking is on and the prompt exceeds one chunk.  Embeds
        requests, misses and short prompts take the bucketed group
        prefill."""
        if req.embeds is not None:
            return False, None
        m = None
        if self.prefix is not None:
            # always leave >= 1 row to prefill: the first sampled token
            # needs logits, and a fully shared prompt would give none
            m = self.prefix.match(req.prompt, len(req.prompt) - 1)
            if m.total_rows == 0:
                m = None
        chunked = self.prefill_chunk is not None and len(req.prompt) > self.prefill_chunk
        return (m is not None or chunked), m

    def _ensure_pages(self, need: int, protect=()) -> bool:
        """Free-list pressure valve: retained prefixes are reclaimable
        memory, so an admission short of pages evicts LRU index entries
        (pages only the index references) until `need` pages are free.
        `protect` shields the pages of the admission's own match: evicting
        one would free a page its block table is about to map."""
        short = need - self.kv.n_free_pages
        if short > 0 and self.prefix is not None:
            freed = self.prefix.evict(self.kv, short, protect=protect)
            if freed:
                self._m_evictions.inc(freed)
        return need <= self.kv.n_free_pages

    def _admit(self, finished: list[Request]) -> None:
        if self.policy == "static" and self._running:
            return  # gang admission: wait for the whole pool to drain
        # overlapped groups hold reservations: their slots and pages are
        # drawn only at commit, so gate on what is genuinely left
        while self._queue and self.kv.n_free - self._pending_slots > 0:
            ext, m = self._extension_plan(self._queue[0])
            if ext:
                n_shared = len(m.page_ids) if m else 0
                need = self.kv.pages_needed(self._reserve_rows(self._queue[0])) - n_shared
                protect = () if m is None else tuple(m.page_ids) + (
                    () if m.cow_src is None else (m.cow_src,))
                if not self._ensure_pages(need + self._pending_pages, protect):
                    return  # FIFO head waits for releases, no starvation
                self._start_extension(self._queue.popleft(), m)
                continue

            # group the queue head by (prompt-length bucket, embeds shape):
            # one batched prefill per group (one graph per bucket, width and
            # embeds shape); without bucketing the exact length groups
            def sig(r):
                n = len(r.prompt)
                return (self._prompt_len(n, self._cache_rows(r) - n),
                        None if r.embeds is None else r.embeds.shape)

            head_reserve = self._reserve_rows(self._queue[0])
            if self.kv.paged:
                head_need = self.kv.pages_needed(head_reserve)
                self._ensure_pages(head_need + self._pending_pages)
                if head_need + self._pending_pages > self.kv.n_free_pages:
                    return  # FIFO head waits for releases, no starvation
            pages_left = self.kv.n_free_pages - self._pending_pages
            if self.kv.paged:
                pages_left -= self.kv.pages_needed(head_reserve)
            group = [self._queue.popleft()]
            while (self._queue and len(group) < self.kv.n_free - self._pending_slots
                   and sig(self._queue[0]) == sig(group[0])
                   and not self._extension_plan(self._queue[0])[0]):
                if self.kv.paged:
                    need = self.kv.pages_needed(self._reserve_rows(self._queue[0]))
                    if need > pages_left:
                        break
                    pages_left -= need
                group.append(self._queue.popleft())
            self._admit_group(group, finished)

    def _prefill_buffers(self, s_b: int, k_b: int, eshape=None) -> dict:
        """The static inputs, stripe template (and the draft model's) and
        first-token output of the prefill graphs of one (bucket, width,
        embeds shape)."""
        key = (s_b, k_b, eshape)
        io = self._prefill_io.get(key)
        if io is None:
            def vec(dtype, *shape):
                return torch.zeros(shape or (k_b,), dtype=dtype, device=self.device)

            io = self._prefill_io[key] = {
                "tokens": vec(torch.int32, k_b, s_b), "n_rows": vec(torch.int32),
                "seeds": vec(torch.int64), "temp": vec(torch.float32),
                "topk": vec(torch.int32), "topp": vec(torch.float32),
                "first": vec(torch.int32), "cache": self.kv.template(k_b)}
            if eshape is not None:
                io["embeds"] = vec(torch.float32, k_b, *eshape)
            if self.draft_kv is not None:
                # the draft model's rows: the prompt's alone
                io["d_rows"] = vec(torch.int32)
                io["draft_cache"] = self.draft_kv.template(k_b)
        return io

    def _prefill_body(self, io: dict, stochastic: bool):
        """Prefill `io`'s tokens into its stripe template and draw each
        row's first token (token index 0 of its stream)."""
        def body():
            cache = io["cache"]
            zoo.rewind_cache(self.cfg, cache)    # a pristine template's offset
            last = zoo.prefill(self.params, self.cfg, io["tokens"], cache,
                               embeds=io.get("embeds"),
                               n_rows=io["n_rows"] if self.bucket else None)
            logits = zoo.logits_fn(self.params, self.cfg, last)[:, : self._vocab].float()
            if stochastic:
                keys = sampler.fold_keys(self._key, io["seeds"],
                                         torch.zeros_like(io["seeds"]))
                first = sampler.sample(keys, logits, io["temp"], io["topk"], io["topp"])
            else:
                first = sampler.greedy(logits)
            io["first"].copy_(first)
        return body

    def _draft_prefill_body(self, io: dict):
        """Prefill `io`'s tokens into its draft stripe template (the draft
        model's own rows of the same prompts; a frontend is the target's)."""
        def body():
            cache = io["draft_cache"]
            zoo.rewind_cache(self.drafter.cfg, cache)
            zoo.prefill(self.drafter.params, self.drafter.cfg, io["tokens"], cache,
                        n_rows=io["d_rows"] if self.bucket else None)
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
        # sentinel-masked and discarded.  Without bucketing the group's
        # prompts share their exact length and nothing is padded
        n0 = len(group[0].prompt)
        s_b = self._prompt_len(n0, self._cache_rows(group[0]) - n0)
        k_b = k
        if self.bucket:
            k_b = 1
            while k_b < k:
                k_b *= 2
        tokens = np.zeros((k_b, s_b), np.int32)
        padded = [group[min(i, k - 1)] for i in range(k_b)]
        for i, r in enumerate(padded):
            tokens[i, : len(r.prompt)] = r.prompt
        eshape = None if group[0].embeds is None else tuple(group[0].embeds.shape)
        io = self._prefill_buffers(s_b, k_b, eshape)
        staged = {"tokens": tokens, "n_rows": [self._cache_rows(r) for r in padded]}
        if eshape is not None:
            staged["embeds"] = np.stack([r.embeds for r in padded])
        if self.draft_kv is not None:
            staged["d_rows"] = [len(r.prompt) for r in padded]
        stochastic = any(r.params.temperature > 0 for r in group)
        if stochastic:
            staged.update(seeds=[self._eff_seed(r) & prng.M32 for r in padded],
                          temp=[r.params.temperature for r in padded],
                          topk=[r.params.top_k for r in padded],
                          topp=[r.params.top_p for r in padded])
        for name, vals in staged.items():
            io[name].copy_(to_device(torch.as_tensor(np.asarray(vals), dtype=io[name].dtype),
                                     self.device))
        with self.telemetry.annotation("serve_prefill"):
            self._program(("prefill", s_b, k_b, stochastic, eshape),
                          self._prefill_body(io, stochastic))
        first = self._fetch(io["first"])
        if self.draft_kv is not None:
            # the draft model prefills the same prompts into its own pool
            self._program(("draft_prefill", s_b, k_b), self._draft_prefill_body(io))
        t1 = time.perf_counter()
        cache_k = io["cache"]
        draft_cache_k = io.get("draft_cache")
        self.stats.prefill_rows += sum(self._cache_rows(r) for r in group)
        if self.telemetry.enabled:
            tr = self.telemetry.tracer
            self.telemetry.registry.histogram(
                "serve_prefill_seconds", labels={"bucket": str(s_b)}).observe(t1 - t0)
            tr.span("scheduler", f"prefill[b{s_b}]", t0, t1, requests=k, bucket=s_b)
            for req in group:
                self._m_admit_wait.observe(req.admit_time - req.submit_time)
                tr.request_span(req, "queued", req.submit_time, req.admit_time)
                tr.request_span(req, f"prefill[b{s_b}]", t0, t1)
        if self.flight is not None:
            # one event per admission group: its members, bucket geometry,
            # and whether it was prepared under a chunk in flight (its
            # `commit` events then land at the next step's start)
            self.flight.emit("admit", group=[r.rid for r in group], bucket=s_b, width=k_b,
                             overlap=bool(self.async_admission and self._chunk_in_flight))
        if self.async_admission and self._chunk_in_flight:
            # overlapped: its host time hid under the chunk, so it is not
            # charged to prefill_seconds.  Another group of this bucket and
            # width may replay the same graph before this one commits, so
            # the group keeps its own copy of the stripe (its first tokens
            # are already on their way to the host)
            cache_k = T.map(torch.clone, cache_k)
            if draft_cache_k is not None:
                draft_cache_k = T.map(torch.clone, draft_cache_k)
            self._pending_admits.append((group, first, cache_k, draft_cache_k))
            self._pending_slots += k
            if self.kv.paged:
                self._pending_pages += sum(self.kv.pages_needed(self._reserve_rows(r))
                                           for r in group)
            self._m_overlap_admit.inc()
            return
        self.stats.prefill_seconds += time.perf_counter() - t0
        self._commit_group((group, first, cache_k, draft_cache_k), finished)

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
        group, first, cache_k, draft_cache_k = rec
        tc0 = time.perf_counter()
        if self._chunk_in_flight:  # canary: committing under a chunk blocks
            self._m_inflight_syncs.inc()
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
                if self.flight is not None:
                    self.flight.emit("commit", rid=req.rid, slot=None, first=first_i,
                                     finished=True)
                self._finish(req, finished)
                continue
            slot = self.kv.acquire()
            self.kv.insert(slot, cache_k, self._cache_rows(req), row=row,
                           reserve=self._reserve_rows(req))
            if self.prefix is not None and req.embeds is None:
                # index this prompt's full pages (retention references): the
                # next identical prefix maps them instead of recomputing them
                self.prefix.register(req.prompt, self.kv.slot_pages(slot), self.kv)
            if self.draft_kv is not None:
                dslot = self.draft_kv.acquire()
                assert dslot == slot, "draft pool diverged from target pool"
                self.draft_kv.insert(slot, draft_cache_k, len(req.prompt), row=row,
                                     reserve=len(req.prompt) + p.max_new_tokens)
            armed.append((slot, req, first_i, eos))
            self._active_host[slot] = True
            req.state = RequestState.DECODING
            req.slot = slot
            self._running[slot] = req
            if self.flight is not None:
                self.flight.emit("commit", rid=req.rid, slot=slot, first=first_i,
                                 finished=False)
            if self.telemetry.enabled:
                # the decode span: closed by `_finish`, or auto-closed at
                # export if the request is abandoned
                req.spans.append(self.telemetry.tracer.begin(
                    f"req{req.rid}", "decode", t0=now, rid=req.rid))
        if armed:
            self._arm(armed)
        self.stats.prefill_seconds += time.perf_counter() - tc0

    # -- extension admission (prefix sharing, chunked prefill) ---------------

    def _start_extension(self, req: Request, m) -> None:
        """Begin an extension admission: acquire a slot, map the shared
        prefix pages (a reference more each) and fresh suffix pages into its
        block table, copying only a divergent tail page, and queue the slot
        for suffix prefill (`_advance_prefill`).  No stripe scatter: shared
        pages are co-owned, and fresh rows are written in the pool by
        `zoo.extend_step`.  Under async admission this may run while a
        decode chunk is in flight; its pool writes queue behind the chunk on
        the one stream."""
        req.state = RequestState.PREFILLING
        req.admit_time = time.perf_counter()
        slot = self.kv.acquire()
        shared = m.page_ids if m is not None else []
        self.kv.map_slot(slot, shared, len(shared) * self.kv.page, self._reserve_rows(req),
                         cow_src=m.cow_src if m is not None else None,
                         cow_rows=m.cow_rows if m is not None else 0)
        if self.draft_kv is not None:
            # the draft pool acquires in lockstep now (slot ids stay aligned
            # with the target pool); its stripe is prefilled in one shot when
            # the admission completes
            dslot = self.draft_kv.acquire()
            assert dslot == slot, "draft pool diverged from target pool"
        hit = m.total_rows if m is not None else 0
        req.prefix_hit_tokens = hit
        req.prefill_cursor = hit
        self.stats.prefix_hit_tokens += hit
        if hit:
            self._m_hit_tokens.inc(hit)
        req.slot = slot
        self._prefilling[slot] = req
        if self.flight is not None:
            # the prefix decision this admission rode: pages mapped by
            # reference, the copy-on-write page, prompt rows never prefilled
            self.flight.emit("ext_admit", rid=req.rid, slot=slot,
                             shared=[int(p) for p in shared],
                             cow_src=None if m is None else m.cow_src,
                             cow_rows=0 if m is None else m.cow_rows, hit=hit)
        if self.telemetry.enabled:
            self._m_admit_wait.observe(req.admit_time - req.submit_time)
            self.telemetry.tracer.request_span(req, "queued", req.submit_time,
                                               req.admit_time)

    def _extend_buffers(self, width: int) -> dict:
        """The static inputs and first-token output of the extension graphs
        of one width bucket (one row per slot)."""
        io = self._extend_io.get(width)
        if io is None:
            def vec(dtype, *shape):
                return torch.zeros(shape or (self.max_slots,), dtype=dtype, device=self.device)

            io = self._extend_io[width] = {
                "tokens": vec(torch.int32, self.max_slots, width), "keep": vec(torch.int32),
                "seeds": vec(torch.int64), "temp": vec(torch.float32),
                "topk": vec(torch.int32), "topp": vec(torch.float32),
                "first": vec(torch.int32)}
        return io

    def _extend_body(self, io: dict, width: int, sample: bool, stochastic: bool):
        """Write `width` token rows per lane from each slot's position
        through the multi-token decode path, then sweep as after a
        speculation: each lane keeps its `keep` real rows (padded chunk rows
        and every other lane's junk writes rewind), so co-resident decode
        state is untouched.  With `sample` the final chunk also projects
        each lane's last real row and draws its first token with the key
        admission prefill uses (seed, index 0): chunked and whole
        admissions emit the same streams."""
        def body():
            cache = self.kv.cache
            pos0 = zoo.cache_position(self.cfg, cache)
            x, undo = zoo.extend_step(self.params, self.cfg, io["tokens"], cache)
            zoo.cache_rollback(self.cfg, cache, undo, pos0, io["keep"], width)
            if not sample:
                return
            lanes = torch.arange(self.max_slots, device=x.device)
            last = x[lanes, torch.clamp(io["keep"] - 1, min=0).long()]
            logits = zoo.logits_fn(self.params, self.cfg, last)[:, : self._vocab].float()
            if stochastic:
                keys = sampler.fold_keys(self._key, io["seeds"], torch.zeros_like(io["seeds"]))
                first = sampler.sample(keys, logits, io["temp"], io["topk"], io["topp"])
            else:
                first = sampler.greedy(logits)
            io["first"].copy_(first)
        return body

    def _advance_prefill(self, finished: list[Request]) -> None:
        """One extension-prefill chunk for every mid-admission slot, in one
        program: each prefilling lane writes its next `min(remaining,
        prefill_chunk)` suffix rows from its position; every other lane's
        junk writes are swept (keep 0).  Lanes whose suffix completes draw
        their first token from the chunk's last real row and graduate to
        decode (one sync per sampling chunk)."""
        if not self._prefilling:
            return
        chunk_w = self.prefill_chunk or self.max_seq
        items = []
        for slot, req in self._prefilling.items():
            remaining = len(req.prompt) - req.prefill_cursor
            width = min(remaining, chunk_w)
            items.append((slot, req, width, width == remaining))
        w_b = self._prompt_len(max(w for _, _, w, _ in items))
        sample = any(last for _, _, _, last in items)
        stochastic = any(last and req.params.temperature > 0 for _, req, _, last in items)
        s = self.max_slots
        tokens = np.zeros((s, w_b), np.int32)
        staged = {name: np.zeros((s,), dt) for name, dt in (
            ("keep", np.int32), ("seeds", np.int64), ("temp", np.float32),
            ("topk", np.int32), ("topp", np.float32))}
        for slot, req, width, _ in items:
            cur = req.prefill_cursor
            tokens[slot, :width] = req.prompt[cur:cur + width]
            staged["keep"][slot] = width
            staged["seeds"][slot] = self._eff_seed(req) & prng.M32
            staged["temp"][slot] = req.params.temperature
            staged["topk"][slot] = req.params.top_k
            staged["topp"][slot] = req.params.top_p
        t0 = time.perf_counter()
        io = self._extend_buffers(w_b)
        for name, vals in (("tokens", tokens), *staged.items()):
            io[name].copy_(to_device(torch.from_numpy(vals), self.device))
        with self.telemetry.annotation("serve_prefill_chunk"):
            self._program(("extend", w_b, sample, stochastic),
                          self._extend_body(io, w_b, sample, stochastic))
            if sample and self._chunk_in_flight:  # canary: see _commit_group
                self._m_inflight_syncs.inc()
            first_np = self._fetch(io["first"])()[0] if sample else None  # one sync
        now = time.perf_counter()
        self.stats.prefill_seconds += now - t0
        n_lanes = len(items)
        self._m_chunks.inc(n_lanes)
        if self.telemetry.enabled:
            self.telemetry.registry.histogram(
                "serve_prefill_chunk_seconds",
                labels={"bucket": str(w_b)}).observe(now - t0, n=n_lanes)
            self.telemetry.tracer.span("scheduler", f"prefill_chunk[b{w_b}]", t0, now,
                                       lanes=n_lanes, bucket=w_b)
        for slot, req, width, last in items:
            req.prefill_cursor += width
            req.prefill_chunks += 1
            self.stats.prefill_chunks += 1
            self.stats.prefill_rows += width
            self.kv.slot_len[slot] += width
            if self.flight is not None:
                self.flight.emit("chunk", rid=req.rid, slot=slot, width=width,
                                 cursor=req.prefill_cursor, last=last)
            if self.telemetry.enabled:
                self.telemetry.tracer.request_span(req, f"prefill_chunk[b{w_b}]", t0, now)
            if last:
                self._complete_admission(slot, req, int(first_np[slot]), now, finished)

    def _complete_admission(self, slot: int, req: Request, first_i: int, now: float,
                            finished: list[Request]) -> None:
        """Graduate a finished extension admission to decode: register its
        full prompt pages in the prefix index (what a later identical prefix
        hits), prefill the draft stripe with the whole prompt in one shot
        under a model drafter, and arm its decode lane, with the n-gram
        history seeded from the whole prompt, page-mapped rows included; or
        finish at once on a first-token EOS or a one-token budget."""
        p = req.params
        eos = self._eff_eos(req)
        req.tokens.append(first_i)
        req.first_token_time = now
        self.stats.tokens_generated += 1
        del self._prefilling[slot]
        if self.prefix is not None:
            self.prefix.register(req.prompt, self.kv.slot_pages(slot), self.kv)
        if self.telemetry.enabled:
            self.telemetry.tracer.request_span(req, "prefill", req.admit_time, now,
                                               hit_tokens=req.prefix_hit_tokens,
                                               chunks=req.prefill_chunks)
        if (eos >= 0 and first_i == eos) or p.max_new_tokens <= 1:
            # unlike the group path this slot exists (its pages were mapped
            # before prefill), so release it; registered pages live on
            # through the index's references
            if self.flight is not None:
                self.flight.emit("graduate", rid=req.rid, slot=slot, first=first_i,
                                 finished=True)
            self.kv.release(slot)
            if self.draft_kv is not None:
                self.draft_kv.release(slot)
            self._finish(req, finished)
            return
        if self.draft_kv is not None:
            n = len(req.prompt)
            s_b = self._prompt_len(n)
            io = self._prefill_buffers(s_b, 1)
            tokens = np.zeros((1, s_b), np.int32)
            tokens[0, :n] = req.prompt
            io["tokens"].copy_(to_device(torch.from_numpy(tokens), self.device))
            io["d_rows"].fill_(n)
            self._program(("draft_prefill", s_b, 1), self._draft_prefill_body(io))
            self.draft_kv.insert(slot, io["draft_cache"], n, row=0,
                                 reserve=n + p.max_new_tokens)
        self._arm([(slot, req, first_i, eos)])
        self._active_host[slot] = True
        req.state = RequestState.DECODING
        self._running[slot] = req
        if self.flight is not None:
            self.flight.emit("graduate", rid=req.rid, slot=slot, first=first_i,
                             finished=False)
        if self.telemetry.enabled:
            # the decode span, as `_commit_group` opens it
            req.spans.append(self.telemetry.tracer.begin(
                f"req{req.rid}", "decode", t0=now, rid=req.rid))

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
        if self.draft_kv is not None:
            self.draft_kv.release(slot)
        self._running.pop(slot)
        self._active_host[slot] = False

    def _stochastic(self) -> tuple[bool, bool]:
        """(some running request samples, some sampled one uses "reject"):
        the draw and the rejection pipeline run only when a lane needs
        them, so an all-greedy pool pays a plain argmax."""
        sampled = [r for r in self._running.values() if r.params.temperature > 0]
        return bool(sampled), any(r.params.spec_accept == "reject" for r in sampled)

    def _draw(self, logits: torch.Tensor, gens: torch.Tensor, stochastic: bool,
              lanes: slice = slice(None)):
        """Each slot's next token from its (B, V) f32 logits at token index
        `gens`: its own sampling parameters, or argmax for an all-greedy
        pool.  `lanes`: the slots the rows are (all by default)."""
        if not stochastic:
            return sampler.greedy(logits)
        keys = sampler.fold_keys(self._key, self._seeds[lanes], gens[lanes])
        return sampler.sample(keys, logits, self._temp[lanes], self._topk[lanes],
                              self._topp[lanes])

    def _chunk_body(self, stochastic: bool, guarded: bool):
        """`decode_chunk` decode steps over the whole slot pool, into
        `_emits` (chunk, slots), -1 where a lane was inactive.  Per step:
        draw where active (`_draw`), count the token index and the budget,
        stop a lane at its EOS or when its budget is spent.  The lane state
        moves on in place.  `guarded` (while a slot is mid-extension-
        prefill): inactive lanes still write junk rows and advance their
        position every step, which would corrupt a prefilling slot's
        committed rows, so the chunk ends with the sweep a fully rejected
        speculation takes: keep 0 for the `_protect` lanes, the whole chunk
        for the rest."""
        def body():
            with self._decode_lanes() as (cache, lanes):
                self._chunk_steps(cache, lanes, stochastic, guarded)
        return body

    @contextlib.contextmanager
    def _decode_lanes(self):
        """(cache, lanes): the decode chunk's cache view and slots on this
        rank — the whole pool and every slot off a mesh, the rank's own
        slots over the whole pool on one (`SlotKVCache.data_parallel`)."""
        lo, hi = self._lanes_lo, self._lanes_hi
        if self.mesh is None:
            yield self.kv.cache, slice(None)
            return
        with self.kv.data_parallel(lo, hi) as view:
            yield view, slice(lo, hi)

    def _gather_lanes(self, t: torch.Tensor, lanes: slice) -> torch.Tensor:
        """The whole batch's rows of `t` from every dp rank's lanes."""
        if lanes == slice(None) or lanes.stop - lanes.start == self.max_slots:
            return t
        dp = sharding.batch_axes(self.mesh)
        return collectives.gather_cat(t, self.mesh, dp if len(dp) > 1 else dp[0], dim=0)

    def _chunk_steps(self, cache, lanes: slice, stochastic: bool, guarded: bool) -> None:
        """The chunk body's steps over `cache` (`_decode_lanes`): each step
        decodes this rank's lanes, draws their tokens and all-gathers them;
        the lane bookkeeping runs over the whole batch on every rank."""
        pos_entry = zoo.cache_position(self.cfg, cache) if guarded else None
        tok, active, rem, gens = self._tok, self._active, self._rem, self._gens
        for i in range(self.decode_chunk):
            logits = zoo.decode_step(self.params, self.cfg, tok[lanes], cache)
            nxt = self._gather_lanes(
                self._draw(logits[:, : self._vocab].float(), gens, stochastic, lanes),
                lanes)
            self._emits[i].copy_(torch.where(active, nxt, -1))
            step = active.to(torch.int32)
            gens = gens + step
            rem = rem - step
            hit_eos = active & (self._eos >= 0) & (nxt == self._eos)
            active = active & ~hit_eos & (rem > 0)
            tok = torch.where(active, nxt, tok[:, 0])[:, None]
        self._store((tok, active, rem, gens))
        if guarded:
            keep = torch.where(self._protect, 0, self.decode_chunk).to(torch.int32)
            zoo.cache_rollback(self.cfg, cache, None, pos_entry, keep[lanes],
                               self.decode_chunk)

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
        tele = self.telemetry.enabled
        if tele and self._last_sync is not None:
            self._m_host_gap.observe(t0 - self._last_sync)
        stochastic = self._stochastic()[0]
        guarded = bool(self._prefilling)
        if guarded:
            protect = np.zeros((self.max_slots,), bool)
            protect[list(self._prefilling)] = True
            self._protect.copy_(to_device(torch.from_numpy(protect), self.device))
        with self.telemetry.annotation("serve_decode_chunk", step=self.stats.decode_steps):
            self._program(("chunk", stochastic, guarded), self._chunk_body(stochastic, guarded))
            fetched = self._fetch(self._emits, self._active)
            self._overlap_admit(finished)        # chunk in flight: prepare admission
            emits, active_np = fetched()         # the chunk's one sync
        t1 = time.perf_counter()
        self.stats.decode_seconds += t1 - t0
        self.stats.decode_steps += self.decode_chunk
        self.stats.step_time_hist.observe((t1 - t0) / self.decode_chunk,
                                          n=self.decode_chunk)
        if tele:
            self._m_step.observe((t1 - t0) / self.decode_chunk, n=self.decode_chunk)
            self.telemetry.tracer.span("scheduler", "decode_chunk", t0, t1,
                                       steps=self.decode_chunk,
                                       lanes=int(self._active_host.sum()))
        self._last_sync = t1
        width = np.maximum((emits >= 0).sum(axis=1), 1)  # active lanes per step
        for slot, req in list(self._running.items()):
            col = emits[:, slot]
            mine = col >= 0
            new = col[mine].tolist()
            req.tokens.extend(new)
            req.shared_decode_steps += float((1.0 / width)[mine].sum())
            self.stats.tokens_generated += len(new)
            self.stats.decode_tokens += len(new)
            # slot_len = actual cache rows: prompt rows + one row per
            # decode-emitted token (the newest token's row lands on the
            # step that feeds it back)
            self._grow(slot, len(new))
            if self.flight is not None and new:
                self.flight.emit("emit", rid=req.rid, slot=slot, tokens=new)
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

    def _draft_steps(self, tok: torch.Tensor):
        """The model drafter's proposal: k + 1 greedy decode steps of the
        draft model in its pool from the pending token `tok` (B, 1), over
        the vocabulary both models share.  The extra step writes the last
        draft's own row, so the draft pool tracks the target's row for row
        and one accept count rolls both back.  Returns (drafts (B, k), the
        draft pool's positions before the steps)."""
        dcfg, dcache = self.drafter.cfg, self.draft_kv.cache
        vcap = min(dcfg.vocab, self._vocab)
        dpos0 = zoo.cache_position(dcfg, dcache)
        steps = []
        for _ in range(self.spec.k + 1):
            logits = zoo.decode_step(self.drafter.params, dcfg, tok, dcache)
            tok = logits[:, :vcap].argmax(dim=-1).to(torch.int32)[:, None]
            steps.append(tok)
        return torch.cat(steps[: self.spec.k], dim=1), dpos0

    def _spec_fused_body(self, stochastic: bool, any_reject: bool):
        """Every cycle of a step on the device (the reference's fused scan):
        the proposal (n-gram lookup, or the draft model's steps), verify,
        acceptance, history append and `zoo.cache_rollback`, the draft pool
        rolled back with the same accept count, into `_spec_out`; the lanes
        move on in place."""
        s_width, out = self.spec.k + 1, self._spec_out

        def body():
            lanes = self._lanes()
            for c in range(self._spec_cycles):
                tok, _, _, _, hist, hlen = lanes
                if self.draft_kv is None:
                    drafts = spec_mod.ngram_propose(hist, hlen, tok, self.spec.k,
                                                    n=self.drafter.n)
                else:
                    drafts, dpos0 = self._draft_steps(tok)
                pos0, undo, emits, cnt, judged, lanes = self._verify(
                    lanes, drafts, stochastic, any_reject)
                zoo.cache_rollback(self.cfg, self.kv.cache, undo, pos0, cnt, s_width)
                if self.draft_kv is not None:
                    zoo.cache_rollback(self.drafter.cfg, self.draft_kv.cache, None, dpos0, cnt,
                                       s_width)
                for name, val in (("emits", emits), ("cnt", cnt), ("judged", judged)):
                    out[name][c].copy_(val)
            self._store(lanes)
        return body

    def _propose_body(self):
        """The drafter's (slots, k) proposals into `_drafts` (and, under a
        model drafter, its pool's positions before them into
        `_draft_pos0`)."""
        if self.draft_kv is None:
            self._drafts.copy_(spec_mod.ngram_propose(self._hist, self._hlen, self._tok,
                                                      self.spec.k, n=self.drafter.n))
            return
        drafts, dpos0 = self._draft_steps(self._tok)
        self._drafts.copy_(drafts)
        self._draft_pos0.copy_(dpos0)

    def _verify_body(self, stochastic: bool, any_reject: bool):
        """One verify of `_drafts` with acceptance and history, into
        `_verify_out` (a sequential verifier's undo into `_verify_undo`);
        the lanes move on in place."""
        def body():
            pos0, undo, emits, cnt, judged, lanes = self._verify(
                self._lanes(), self._drafts, stochastic, any_reject)
            for name, val in (("pos0", pos0), ("emits", emits), ("cnt", cnt),
                              ("judged", judged)):
                self._verify_out[name].copy_(val)
            if undo is not None:
                if self._verify_undo is None:
                    self._verify_undo = T.map(torch.empty_like, undo)
                T.map(lambda dst, src: dst.copy_(src), self._verify_undo, undo)
            self._store(lanes)
        return body

    def _spec_cycles_run(self, stochastic: bool, any_reject: bool) -> None:
        """Every cycle of a step into `_spec_out`.  Fused: one program.
        Unfused: per cycle the proposal and the verify as programs of their
        own (the drafts' host time kept apart) and the rollbacks (the
        target's, and the draft pool's under a model drafter) through
        `SlotKVCache.rollback`, as the reference dispatches them."""
        if self.spec.fused:
            with self.telemetry.annotation("serve_spec_fused", step=self.stats.decode_steps):
                self._program(("spec", stochastic, any_reject),
                              self._spec_fused_body(stochastic, any_reject))
            self._m_spec_dispatch.inc()
            self.kv.note_scan_rollbacks(self._spec_cycles)
            if self.draft_kv is not None:
                self.draft_kv.note_scan_rollbacks(self._spec_cycles)
            return
        vout, tele = self._verify_out, self.telemetry.enabled
        for c in range(self._spec_cycles):
            # host windows of the proposal and the verify programs (the one
            # sync stays the harvest's)
            td0 = time.perf_counter()
            with self.telemetry.annotation("serve_spec_draft"):
                self._program(("propose",), self._propose_body)
            td1 = time.perf_counter()
            self.stats.spec_draft_seconds += td1 - td0
            with self.telemetry.annotation("serve_spec_verify"):
                self._program(("verify", stochastic, any_reject),
                              self._verify_body(stochastic, any_reject))
                self.kv.rollback(vout["pos0"], vout["cnt"], self.spec.k + 1,
                                 undo=self._verify_undo)
                if self.draft_kv is not None:
                    self.draft_kv.rollback(self._draft_pos0, vout["cnt"], self.spec.k + 1)
            # the unfused chain per cycle: proposal + verify + target
            # rollback (+ the draft's rollback under a model drafter)
            self._m_spec_dispatch.inc(3 if self.draft_kv is None else 4)
            if tele:
                td2 = time.perf_counter()
                self._m_spec_draft.observe(td1 - td0)
                self._m_spec_verify.observe(td2 - td1)
                self.telemetry.tracer.span("scheduler", "spec_draft", td0, td1)
                self.telemetry.tracer.span("scheduler", "spec_verify", td1, td2)
            for name in ("emits", "cnt", "judged"):
                self._spec_out[name][c].copy_(vout[name])

    def _spec_decode_and_harvest(self, finished: list[Request]) -> None:
        """Draft/verify decode: each cycle proposes k drafts per slot,
        verifies them with one forward, keeps the accepted prefix and
        sweeps the rejected rows — up to k+1 tokens per slot per packed
        weight read.  One host sync per scheduler step."""
        cycles = self._spec_cycles
        tele = self.telemetry.enabled
        t0 = time.perf_counter()
        if tele and self._last_sync is not None:
            self._m_host_gap.observe(t0 - self._last_sync)
        st = self.stats
        dp0, da0 = st.draft_proposed, st.draft_accepted
        self._spec_cycles_run(*self._stochastic())
        out = self._spec_out
        fetched = self._fetch(out["emits"], out["cnt"], out["judged"], self._active)
        self._overlap_admit(finished)        # cycles in flight: prepare admission
        # (cycles, slots, k+1), (cycles, slots) x 2, (slots,): the one sync
        emits_np, cnts_np, judged_np, active_np = fetched()
        t1 = time.perf_counter()
        st.decode_seconds += t1 - t0
        st.decode_steps += cycles
        st.verify_steps += cycles
        st.step_time_hist.observe((t1 - t0) / cycles, n=cycles)
        if tele:
            self._m_step.observe((t1 - t0) / cycles, n=cycles)
            self.telemetry.tracer.span("scheduler", "spec_cycles", t0, t1, cycles=cycles,
                                       lanes=int(self._active_host.sum()))
        self._last_sync = t1
        # lanes that emitted in a cycle share that cycle's weight read
        width = np.maximum((cnts_np > 0).sum(axis=1), 1)
        for slot, req in list(self._running.items()):
            cnt = cnts_np[:, slot]
            rode_mask = cnt > 0
            rode = int(rode_mask.sum())
            col = emits_np[:, slot, :].reshape(-1)
            new = col[col >= 0].tolist()
            # drafts whose verdict reached the stream (accepted ones, and an
            # emitted correction's rejected one); drafts past an EOS or
            # budget cut were never judgeable
            proposed = int(judged_np[:, slot].sum())
            accepted = int(np.maximum(cnt - 1, 0).sum())
            req.tokens.extend(new)
            req.shared_decode_steps += float((1.0 / width)[rode_mask].sum())
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
            if self.flight is not None and (new or proposed):
                # the window's draft accounting beside the tokens it earned
                self.flight.emit("emit", rid=req.rid, slot=slot, tokens=new,
                                 proposed=proposed, accepted=accepted)
            if not active_np[slot]:
                self._finish(req, finished)
                self._release_slot(slot)
        dp, da = st.draft_proposed - dp0, st.draft_accepted - da0
        if self.flight is not None:
            self.flight.emit("spec_window", cycles=cycles, proposed=dp, accepted=da)
        if tele and dp:
            # this harvest's acceptance (a drift here flags the drafter
            # decaying over the workload, which the aggregate averages away)
            self._m_spec_accept.observe(da / dp)

    def step(self) -> list[Request]:
        """One scheduler iteration: admit (extension admissions map their
        shared pages and start), advance every mid-prefill slot by one
        chunk, one decode chunk, harvest.  Returns requests that finished
        this step.

        With async admission the groups prepared under the previous chunk
        commit first; the chunk then dispatches and `_admit` prepares the
        next groups while it runs.  An idle pool has nothing to overlap
        with: it admits and commits synchronously, so fresh slots decode
        this very step.

        An exception escaping a step triggers the flight recorder's crash
        dump (pool, block tables, refcounts, requests in flight, the event
        tail) and closes every open trace span, so both stay loadable."""
        try:
            return self._step_inner()
        except Exception as exc:
            if self.flight is not None:
                self.flight.crash_dump(self, exc)
            self.telemetry.tracer.finalize()
            raise

    @torch.no_grad()
    def _step_inner(self) -> list[Request]:
        finished: list[Request] = []
        if self.async_admission:
            self._commit_admissions(finished)
            self._advance_prefill(finished)
            if not self._active_host.any():
                self._admit(finished)
                self._commit_admissions(finished)
        else:
            self._admit(finished)
            self._advance_prefill(finished)
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
