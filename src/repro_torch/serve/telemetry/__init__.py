"""Serving observability (port of `repro.serve.telemetry`): metrics registry
+ request-lifecycle tracing.

`Telemetry` is the bundle the scheduler threads through the runtime — a
`MetricsRegistry` (counters / gauges / log-bucketed histograms, see
`metrics.py`) plus a `TraceRecorder` (Chrome-trace span export, see
`tracing.py`) behind one `enabled` switch:

- **disabled (the default)** — the registry still exists and the
  instruments counted once per program built (prefill programs, kernel
  dispatch decisions) still record, because they cost nothing per decode
  step; every wall-clock histogram and span on the hot path is skipped;
- **enabled** — admission / prefill / decode / host-gap / spec phases are
  timed into histograms from host clocks at the scheduler's existing
  sync points (no sync is added), the KV pool's occupancy gauges update,
  and every request accumulates lifecycle spans exported as
  Perfetto-loadable trace JSON.

Resolution order for `Scheduler(telemetry=...)`: a `Telemetry` instance
is used as-is; `True`/`False` build a fresh enabled/disabled bundle;
`None`/"auto" defer to `perf_knobs.KNOBS.telemetry` (off by default).
"""
from __future__ import annotations

import json

from repro_torch.serve.telemetry.metrics import (GLOBAL, Counter, Gauge, Histogram,
                                                 MetricsRegistry, reset_global)
from repro_torch.serve.telemetry.tracing import InstantEvent, SpanEvent, TraceRecorder

__all__ = [
    "GLOBAL",
    "Counter",
    "Gauge",
    "Histogram",
    "InstantEvent",
    "MetricsRegistry",
    "SpanEvent",
    "Telemetry",
    "TraceRecorder",
    "reset_global",
    "resolve_telemetry",
]


class Telemetry:
    def __init__(self, enabled: bool = True, annotate: bool = False,
                 registry: MetricsRegistry | None = None,
                 tracer: TraceRecorder | None = None):
        self.enabled = bool(enabled)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else TraceRecorder(annotate)

    def annotation(self, name: str, step: int | None = None):
        return self.tracer.annotation(name, step)

    def snapshot(self, include_global: bool = True) -> dict:
        """JSON-able snapshot of this bundle's registry, with the
        process-global instruments (kernel dispatch counters) merged in
        under their own key so the two scopes stay distinguishable."""
        snap = {"enabled": self.enabled, **self.registry.snapshot()}
        if include_global:
            snap["global"] = GLOBAL.snapshot()
        return snap

    def dump_metrics(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)

    def dump_trace(self, path: str) -> None:
        self.tracer.dump(path)


def resolve_telemetry(arg) -> Telemetry:
    """Resolve the `Scheduler(telemetry=...)` knob to a `Telemetry`."""
    if isinstance(arg, Telemetry):
        return arg
    if arg is None or arg == "auto":
        from repro_torch.perf_knobs import KNOBS

        return Telemetry(enabled=bool(KNOBS.telemetry))
    return Telemetry(enabled=bool(arg))
