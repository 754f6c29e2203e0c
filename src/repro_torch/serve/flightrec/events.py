"""Flight recorder (port of `repro.serve.flightrec.events`): a bounded ring
buffer of typed scheduler decisions.

Every host-side decision the serving stack makes — admission grouping,
prefix CoW mapping, page ref/deref, LRU eviction, spec accept counts,
fused-loop dispatch, async prepare/commit pairing — lands here as one
`FlightEvent`: a monotonically-sequenced `(seq, kind, data)` record whose
payload carries the causal ids (`rid`, `slot`, `pages`) that tie it to a
request's lifecycle.  Wall-clock time is recorded (`t`) but deliberately
EXCLUDED from event identity: two runs of the same workload on the same
scheduler configuration must produce byte-identical `(kind, data)`
streams, which is what makes a record a deterministic replay script
(`flightrec.replay`) and a diffable conformance artifact
(`flightrec.diff_records`).

The buffer is bounded (`capacity` events, default 64k): in a long-lived
server the recorder keeps the most recent window and counts what it
dropped (`dropped`), so the crash dump always has the tail that led up to
the failure.  `dump()`/`load_jsonl()` round-trip the stream through JSON
lines; `crash_dump()` snapshots the pool's host-side truth — free lists,
page refcounts, block tables, slot lengths, in-flight requests — next to
the event tail when the scheduler dies mid-step.

Chrome-trace bridging: constructed with a `TraceRecorder`, every emit
also lands as an instant event on a `flightrec` track, so decisions line
up against the span timeline in Perfetto.  The scheduler wires the bridge
only when telemetry is enabled; a bare recorder stays trace-free.

Every payload is plain Python built from host state the scheduler
already holds (harvested tokens, host block tables, refcounts): emitting
reads no device tensor, so recording adds no sync.
"""
from __future__ import annotations

import collections
import json
import time


class FlightEvent:
    """One recorded decision. `t` (perf_counter seconds) is diagnostic
    only — `signature()` is the identity replay and diff compare on."""

    __slots__ = ("seq", "kind", "t", "data")

    def __init__(self, seq: int, kind: str, t: float, data: dict):
        self.seq = seq
        self.kind = kind
        self.t = t
        self.data = data

    def signature(self) -> tuple:
        return (self.kind, _canon(self.data))

    def stream_key(self) -> tuple:
        """Causal-stream id: events about one request align under its
        `rid`; pool events with no request attribution align under their
        `slot`; everything else shares the global stream."""
        if "rid" in self.data:
            return ("rid", self.data["rid"])
        if "slot" in self.data:
            return ("slot", self.data["slot"])
        return ("global",)

    def to_dict(self) -> dict:
        return {"seq": self.seq, "kind": self.kind, "t": self.t, **self.data}

    @classmethod
    def from_dict(cls, d: dict) -> "FlightEvent":
        d = dict(d)
        return cls(d.pop("seq"), d.pop("kind"), d.pop("t", 0.0), d)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        body = ", ".join(f"{k}={v!r}" for k, v in self.data.items())
        return f"FlightEvent#{self.seq} {self.kind}({body})"


def _canon(v):
    """Hashable, order-stable form of a payload (lists -> tuples)."""
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    return v


class FlightRecorder:
    def __init__(self, capacity: int = 65536, tracer=None):
        if capacity < 1:
            raise ValueError("FlightRecorder capacity must be >= 1")
        self.capacity = capacity
        self._buf: collections.deque[FlightEvent] = collections.deque(
            maxlen=capacity)
        self.seq = 0          # total events emitted (dropped ones included)
        self.tracer = tracer  # TraceRecorder bridge (instant events), or None
        self.crash: dict | None = None   # last crash_dump() snapshot
        self.crash_path: str | None = None

    # -- recording --------------------------------------------------------

    def emit(self, kind: str, **data) -> FlightEvent:
        ev = FlightEvent(self.seq, kind, time.perf_counter(), data)
        self.seq += 1
        self._buf.append(ev)
        if self.tracer is not None:
            self.tracer.instant("flightrec", kind, ev.t, **data)
        return ev

    @property
    def dropped(self) -> int:
        """Events pushed out of the ring by capacity pressure."""
        return self.seq - len(self._buf)

    @property
    def events(self) -> list[FlightEvent]:
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self.seq = 0
        self.crash = None

    # -- export -----------------------------------------------------------

    def dump(self, path: str) -> None:
        """JSON-lines export: one event per line, in sequence order."""
        with open(path, "w") as f:
            for ev in self._buf:
                f.write(json.dumps(ev.to_dict()) + "\n")

    # -- crash dump -------------------------------------------------------

    def crash_dump(self, scheduler, exc: BaseException | None = None,
                   tail: int = 256) -> dict:
        """Snapshot the scheduler's host-side truth at the moment of
        death: the exception, every in-flight request, the pool's free
        lists / page refcounts / block tables, and the event tail that
        led here.  Stored on `self.crash`; written to `self.crash_path`
        (JSON) when one is set.  Never raises — a crash dump that crashes
        would mask the original failure."""
        try:
            snap = {
                "error": repr(exc) if exc is not None else None,
                "decode_steps": scheduler.stats.decode_steps,
                "requests": _requests_snapshot(scheduler),
                "pool": _pool_snapshot(scheduler.kv),
                "draft_pool": (_pool_snapshot(scheduler.draft_kv)
                               if scheduler.draft_kv is not None else None),
                "pending_admits": [
                    [r.rid for r in rec[0]]
                    for rec in scheduler._pending_admits],
                "prefix_index_pages": (scheduler.prefix.n_pages
                                       if scheduler.prefix is not None
                                       else None),
                "events_dropped": self.dropped,
                "events_tail": [ev.to_dict()
                                for ev in list(self._buf)[-tail:]],
            }
        except Exception as dump_exc:  # pragma: no cover - defensive
            snap = {"error": repr(exc) if exc is not None else None,
                    "dump_error": repr(dump_exc)}
        self.crash = snap
        if self.crash_path:
            try:
                with open(self.crash_path, "w") as f:
                    json.dump(snap, f, indent=1)
            except OSError:  # pragma: no cover - defensive
                pass
        return snap


def _requests_snapshot(scheduler) -> list[dict]:
    reqs = []
    seen = set()
    sources = (
        [("queued", r) for r in scheduler._queue]
        + [("prefilling", r) for r in scheduler._prefilling.values()]
        + [("decoding", r) for r in scheduler._running.values()]
        + [("pending_commit", r) for rec in scheduler._pending_admits
           for r in rec[0]])
    for phase, r in sources:
        if id(r) in seen:
            continue
        seen.add(id(r))
        reqs.append({"rid": r.rid, "phase": phase, "slot": r.slot,
                     "n_prompt": len(r.prompt), "n_tokens": len(r.tokens),
                     "prefill_cursor": r.prefill_cursor,
                     "max_new": r.params.max_new_tokens})
    return reqs


def _pool_snapshot(kv) -> dict:
    snap = {"n_slots": kv.n_slots, "free_slots": list(kv._free),
            "slot_len": [int(x) for x in kv.slot_len],
            "slot_cap": [int(x) for x in kv._slot_cap],
            "paged": kv.paged}
    if kv.paged:
        snap.update({
            "n_pages": kv.n_pages,
            # one free list a page shard, as the reference keeps them
            "free_pages": [list(d) for d in kv._free_pages],
            "page_ref": [int(x) for x in kv._page_ref],
            "block_tables": {str(s): list(p)
                             for s, p in sorted(kv._slot_pages.items())},
            "n_free_pages": kv.n_free_pages,
            "n_referenced_pages": kv.n_referenced_pages,
            "n_shared_pages": kv.n_shared_pages,
            "cow_copies": kv.cow_copies,
        })
    return snap


def load_jsonl(path: str) -> list[FlightEvent]:
    """Load a `FlightRecorder.dump()` JSON-lines record."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(FlightEvent.from_dict(json.loads(line)))
    return events


def as_events(record) -> list[FlightEvent]:
    """Coerce a record argument — recorder, event list, or JSONL path —
    to a plain event list."""
    if isinstance(record, FlightRecorder):
        return record.events
    if isinstance(record, str):
        return load_jsonl(record)
    return list(record)


def resolve_flightrec(arg, tracer=None) -> FlightRecorder | None:
    """Resolve `Scheduler(flightrec=...)`: None/False -> off (the default
    — recording costs a dict build per decision), True -> a fresh
    recorder, an instance -> itself (shared across schedulers if the
    caller wants one merged stream)."""
    if isinstance(arg, FlightRecorder):
        return arg
    if arg:
        return FlightRecorder(tracer=tracer)
    return None
