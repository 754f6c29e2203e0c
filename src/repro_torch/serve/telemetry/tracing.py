"""Request-lifecycle tracing (port of `repro.serve.telemetry.tracing`):
typed spans -> Chrome trace-event JSON.

The scheduler records wall-clock spans on named tracks — one `scheduler`
track for batched phases (admission prefill, decode chunks, spec
draft/verify dispatch) and one `req<rid>` track per request for its
lifecycle (queued -> prefill[bucket] -> decode -> finish).  Request spans
are also kept on `Request.spans` as typed `SpanEvent`s, so tests and
callers can read a lifecycle without parsing the export.

`chrome_trace()` emits the Trace Event Format (B/E duration pairs plus
thread-name metadata) that `chrome://tracing` and Perfetto open directly:
every track becomes a named thread, timestamps are microseconds relative
to the recorder epoch, and events are sorted so B/E pairs nest.

The profiler bridge (`annotation(...)`, on with ``annotate=True``) wraps
host phases in `torch.profiler.record_function`, so a `torch.profiler`
trace shows the scheduler's phases under the same names, around the
device work they enqueue; it is a null context when the bridge is off.
The scheduler opens it around a program's launch or replay, never inside
a captured body.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time


@dataclasses.dataclass
class SpanEvent:
    """One host span: [t0, t1] in perf_counter seconds.  `t1 is None`
    marks a span still open (`TraceRecorder.begin`); export auto-closes
    open spans so an abandoned request or a mid-step exception can never
    leave an unmatched "B" event in the Chrome trace."""

    name: str
    t0: float
    t1: float | None
    track: str = "scheduler"
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0


@dataclasses.dataclass
class InstantEvent:
    """One zero-duration marker (Chrome trace "i" phase) — the flight
    recorder's per-decision bridge onto the span timeline."""

    name: str
    t: float
    track: str = "flightrec"
    args: dict = dataclasses.field(default_factory=dict)


class TraceRecorder:
    def __init__(self, annotate: bool = False):
        self.epoch = time.perf_counter()
        self.events: list[SpanEvent] = []
        self.instants: list[InstantEvent] = []
        self.annotate = annotate
        self._tids: dict[str, int] = {}

    def span(self, track: str, name: str, t0: float, t1: float,
             **args) -> SpanEvent:
        ev = SpanEvent(name, t0, t1, track=track, args=args)
        self.events.append(ev)
        return ev

    def begin(self, track: str, name: str, t0: float | None = None,
              **args) -> SpanEvent:
        """Open a span now; close it later with `end` (or let export /
        `finalize` close it).  For lifecycles that may never reach their
        natural end — a request abandoned mid-decode, a scheduler that
        raises — so the trace stays structurally valid either way."""
        ev = SpanEvent(name, time.perf_counter() if t0 is None else t0,
                       None, track=track, args=args)
        self.events.append(ev)
        return ev

    def end(self, ev: SpanEvent, t1: float | None = None, **args) -> SpanEvent:
        ev.t1 = time.perf_counter() if t1 is None else t1
        ev.args.update(args)
        return ev

    def finalize(self, t: float | None = None) -> int:
        """Close every open span (at `t`, default now). Returns how many
        were open — the scheduler calls this from its exception path so a
        crash leaves a loadable trace, and export calls it implicitly."""
        t = time.perf_counter() if t is None else t
        n = 0
        for ev in self.events:
            if ev.t1 is None:
                ev.t1 = max(ev.t0, t)
                ev.args.setdefault("auto_closed", True)
                n += 1
        return n

    def instant(self, track: str, name: str, t: float | None = None,
                **args) -> InstantEvent:
        ev = InstantEvent(name, time.perf_counter() if t is None else t,
                          track=track, args=args)
        self.instants.append(ev)
        return ev

    def request_span(self, req, name: str, t0: float, t1: float,
                     **args) -> SpanEvent:
        """Record a lifecycle span on the request's own track AND on the
        request object itself (`Request.spans`)."""
        ev = self.span(f"req{req.rid}", name, t0, t1, rid=req.rid, **args)
        req.spans.append(ev)
        return ev

    @contextlib.contextmanager
    def timed(self, track: str, name: str, **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.span(track, name, t0, time.perf_counter(), **args)

    def annotation(self, name: str, step: int | None = None):
        """`torch.profiler` bridge: a `record_function` range named `name`
        (``name[step]`` when `step` is given, the decode step count) when
        the bridge is on, else a null context.  Host spans then share names
        with the profiler's ranges."""
        if not self.annotate:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name if step is None else f"{name}[{step}]")

    # -- export ----------------------------------------------------------

    def _tid(self, track: str) -> int:
        return self._tids.setdefault(track, len(self._tids) + 1)

    def chrome_trace(self) -> dict:
        """Chrome Trace Event Format dict (Perfetto-loadable).

        B/E pairs per span, microsecond timestamps relative to the
        recorder epoch, one named thread per track.  Events are sorted by
        (ts, E-before-B) so back-to-back spans whose edges share a
        timestamp still nest; negative-duration spans are clamped to
        zero-width rather than emitting an unmatched pair, and spans still
        open at export (`begin` without `end`) are auto-closed first —
        the trace parses even when a request was abandoned mid-decode.
        Flight-recorder instants ride along as "i" events.
        """
        self.finalize()
        raw = []
        for ev in self.events:
            tid = self._tid(ev.track)
            ts0 = max(0.0, (ev.t0 - self.epoch) * 1e6)
            # a zero-width pair would sort its E before its own B under
            # the E-before-B tiebreak below; 1ns of width keeps the pair
            # matched (auto-closed spans clamp to their open time)
            ts1 = max(ts0 + 1e-3, (ev.t1 - self.epoch) * 1e6)
            args = {k: v for k, v in ev.args.items()}
            raw.append({"name": ev.name, "cat": "serve", "ph": "B",
                        "ts": ts0, "pid": 0, "tid": tid, "args": args})
            raw.append({"name": ev.name, "cat": "serve", "ph": "E",
                        "ts": ts1, "pid": 0, "tid": tid})
        for iv in self.instants:
            raw.append({"name": iv.name, "cat": "flightrec", "ph": "i",
                        "ts": max(0.0, (iv.t - self.epoch) * 1e6), "pid": 0,
                        "tid": self._tid(iv.track), "s": "t",
                        "args": _json_args(iv.args)})
        raw.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "E" else 1))
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": "repro_torch.serve"}}]
        for track, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": track}})
        return {"traceEvents": meta + raw, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def _json_args(args: dict) -> dict:
    """Instant-event args must survive json.dump (flight payloads carry
    numpy scalars occasionally); anything exotic falls back to str."""
    def f(v):
        if isinstance(v, (list, tuple)):
            return [f(x) for x in v]
        if isinstance(v, (bool, int, float, str)) or v is None:
            return v
        try:
            return v.item()  # numpy scalar
        except AttributeError:
            return str(v)

    return {k: f(v) for k, v in args.items()}
