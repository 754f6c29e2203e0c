"""Low-overhead serving metrics (port of `repro.serve.telemetry.metrics`):
counters, gauges, log-bucketed histograms and the registry that holds them.

The registry is the serving runtime's single sink for numeric
observability: the scheduler times admission / prefill / decode / host-gap
phases into histograms, the KV pool tracks page and slot occupancy through
gauges, and build-time events (prefill programs, paged-attention backend
dispatch) land in labeled counters.  Everything snapshots to plain
JSON-able dicts (`MetricsRegistry.snapshot` / `from_snapshot` round-trip
exactly) and renders Prometheus text exposition.  numpy only: the port
keeps its own copy so it never imports the reference package.

Design constraints, in order:

- **recording must be cheap** — an `observe()` on the decode hot path is
  a float compare, an int bump and (while under the sample cap) a list
  append; no locks, no label dicts built per call.  Callers hold the
  instrument object, not the registry;
- **percentiles must be trustworthy** — a histogram keeps its raw samples
  up to ``sample_cap``, so p50/p90/p99 are exact (numpy-identical) until
  the cap, and only then degrade to log-bucket interpolation;
- **instruments are single-process** — the serving loop is
  single-threaded host code; there is no locking.
"""
from __future__ import annotations

import json
import math

import numpy as np

NAN = float("nan")


def _label_key(labels: dict | None) -> tuple:
    return () if not labels else tuple(sorted(labels.items()))


class Counter:
    """Monotonic event count (floats allowed for weighted counts)."""

    kind = "counter"

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "labels": self.labels, "value": self.value}

    def _restore(self, snap: dict) -> None:
        self.value = snap["value"]


class Gauge:
    """Point-in-time level with high/low-water tracking (`min`/`max`
    observed since creation — the pool's free-page low-water mark is
    `gauge.min` of the free-page gauge, no extra bookkeeping)."""

    kind = "gauge"

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0
        self.min = NAN
        self.max = NAN

    def set(self, v: float) -> None:
        self.value = v
        if not v >= self.min:   # NaN-safe: first set seeds both marks
            self.min = v
        if not v <= self.max:
            self.max = v

    def inc(self, n: float = 1) -> None:
        self.set(self.value + n)

    def dec(self, n: float = 1) -> None:
        self.set(self.value - n)

    def snapshot(self) -> dict:
        return {"name": self.name, "kind": self.kind, "labels": self.labels,
                "value": self.value, "min": self.min, "max": self.max}

    def _restore(self, snap: dict) -> None:
        self.value = snap["value"]
        self.min = snap["min"]
        self.max = snap["max"]


class Histogram:
    """Log-bucketed distribution with exact-percentile extraction.

    Buckets are geometric: upper bounds ``lo * growth**i`` for
    ``i in [0, n_buckets)`` plus a final +inf overflow bucket; values
    ``<= lo`` land in bucket 0.  The defaults (1 microsecond .. ~4000 s
    at growth 2) cover every latency this runtime can produce.

    Raw samples are retained up to ``sample_cap`` so ``percentile`` is
    numpy-exact for bench/test-scale runs; past the cap it falls back to
    geometric interpolation inside the covering bucket (error bounded by
    the bucket width, clamped to the observed [min, max]).
    """

    kind = "histogram"

    def __init__(self, name: str, labels: dict | None = None, *,
                 lo: float = 1e-6, growth: float = 2.0,
                 n_buckets: int = 40, sample_cap: int = 8192):
        if lo <= 0 or growth <= 1 or n_buckets < 1:
            raise ValueError("need lo > 0, growth > 1, n_buckets >= 1")
        self.name = name
        self.labels = dict(labels or {})
        self.lo = float(lo)
        self.growth = float(growth)
        self.n_buckets = int(n_buckets)
        self.sample_cap = int(sample_cap)
        self.counts = [0] * (self.n_buckets + 1)  # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = NAN
        self.max = NAN
        self._samples: list[float] = []

    # -- recording --------------------------------------------------------

    def observe(self, v: float, n: int = 1) -> None:
        """Record `v` (`n` identical observations in one call — e.g. a
        decode chunk's per-step mean observed once per scanned step)."""
        v = float(v)
        self.counts[self._bucket(v)] += n
        self.count += n
        self.sum += v * n
        if not v >= self.min:
            self.min = v
        if not v <= self.max:
            self.max = v
        if len(self._samples) < self.sample_cap:
            self._samples.extend([v] * min(n, self.sample_cap - len(self._samples)))

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.ceil(math.log(v / self.lo) / math.log(self.growth)))
        return min(i, self.n_buckets)

    def bucket_bounds(self, i: int) -> tuple[float, float]:
        """(lower, upper] value range of bucket `i` (upper inf for the
        overflow bucket, lower 0 for the underflow bucket)."""
        up = math.inf if i >= self.n_buckets else self.lo * self.growth ** i
        down = 0.0 if i == 0 else self.lo * self.growth ** (i - 1)
        return down, up

    # -- extraction -------------------------------------------------------

    @property
    def exact(self) -> bool:
        """True while every observation is still individually retained."""
        return self.count == len(self._samples)

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100). Exact (numpy-identical, linear
        interpolation) while under the sample cap; log-bucket estimate
        beyond it. NaN for an empty histogram."""
        if self.count == 0:
            return NAN
        if self.exact:
            return float(np.percentile(self._samples, q))
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                down, up = self.bucket_bounds(i)
                if not math.isfinite(up):
                    return self.max
                frac = 1.0 - (cum - rank) / c
                down = max(down, self.lo / self.growth)
                est = down * (up / down) ** frac  # geometric interpolation
                return float(min(max(est, self.min), self.max))
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else NAN

    def percentiles(self, qs=(50, 90, 99)) -> dict:
        return {f"p{q:g}": self.percentile(q) for q in qs}

    def snapshot(self) -> dict:
        return {"name": self.name, "kind": self.kind, "labels": self.labels,
                "lo": self.lo, "growth": self.growth,
                "n_buckets": self.n_buckets, "sample_cap": self.sample_cap,
                "counts": list(self.counts), "count": self.count,
                "sum": self.sum, "min": self.min, "max": self.max,
                "samples": list(self._samples)}

    def _restore(self, snap: dict) -> None:
        self.counts = list(snap["counts"])
        self.count = snap["count"]
        self.sum = snap["sum"]
        self.min = snap["min"]
        self.max = snap["max"]
        self._samples = list(snap["samples"])


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Instrument store keyed by (name, sorted labels).

    Repeated registration with the same key returns the existing
    instrument, so call sites need no get-or-create dance.  A name maps
    to exactly one instrument kind across all label sets (mixed kinds
    under one name would be un-renderable in Prometheus exposition).
    """

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._kinds: dict[str, str] = {}

    def _get(self, cls, name: str, labels: dict | None, **kw):
        if self._kinds.setdefault(name, cls.kind) != cls.kind:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{self._kinds[name]}, not {cls.kind}")
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(name, labels, **kw)
        return m

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: dict | None = None,
                  **kw) -> Histogram:
        return self._get(Histogram, name, labels, **kw)

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def get(self, name: str, labels: dict | None = None):
        """Existing instrument or None (no registration side effect)."""
        return self._metrics.get((name, _label_key(labels)))

    def value(self, name: str, labels: dict | None = None, default=None):
        m = self.get(name, labels)
        return default if m is None else getattr(m, "value", default)

    # -- snapshot / exposition -------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict snapshot (JSON-able; NaNs mapped to None)."""
        return {"metrics": [_json_safe(m.snapshot()) for m in self]}

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    @classmethod
    def from_snapshot(cls, snap: dict | str) -> "MetricsRegistry":
        """Rebuild a registry from `snapshot()` output (or its JSON)."""
        if isinstance(snap, str):
            snap = json.loads(snap)
        reg = cls()
        for m in snap["metrics"]:
            m = _nan_safe(m)
            mcls = _KINDS[m["kind"]]
            kw = {}
            if m["kind"] == "histogram":
                kw = {k: m[k] for k in ("lo", "growth", "n_buckets",
                                        "sample_cap")}
            inst = reg._get(mcls, m["name"], m["labels"], **kw)
            inst._restore(m)
        return reg

    def render_prometheus(self) -> str:
        """Prometheus text exposition (histograms as cumulative buckets)."""
        by_name: dict[str, list] = {}
        for m in self:
            by_name.setdefault(m.name, []).append(m)
        out = []
        for name, ms in sorted(by_name.items()):
            out.append(f"# TYPE {name} {ms[0].kind}")
            for m in ms:
                if m.kind == "histogram":
                    cum = 0
                    for i, c in enumerate(m.counts):
                        cum += c
                        _, up = m.bucket_bounds(i)
                        le = "+Inf" if not math.isfinite(up) else repr(up)
                        out.append(f"{name}_bucket"
                                   f"{_prom_labels(m.labels, le=le)} {cum}")
                    out.append(f"{name}_sum{_prom_labels(m.labels)} {m.sum}")
                    out.append(f"{name}_count{_prom_labels(m.labels)} {m.count}")
                else:
                    out.append(f"{name}{_prom_labels(m.labels)} {m.value}")
        return "\n".join(out) + "\n"


def _prom_labels(labels: dict, **extra) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    body = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


def _prom_escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _json_safe(d: dict) -> dict:
    """NaN -> None so snapshots survive strict JSON parsers."""
    def f(v):
        if isinstance(v, float) and math.isnan(v):
            return None
        if isinstance(v, list):
            return [f(x) for x in v]
        return v

    return {k: f(v) for k, v in d.items()}


def _nan_safe(d: dict) -> dict:
    def f(k, v):
        if v is None and k in ("min", "max"):
            return NAN
        return v

    return {k: f(k, v) for k, v in d.items()}


def histogram_from_snapshot(snap: dict) -> Histogram:
    """Rebuild a single histogram from its `snapshot()` dict (accepts the
    NaN->None JSON form), without a full registry."""
    h = Histogram(snap["name"], snap.get("labels"),
                  lo=snap["lo"], growth=snap["growth"],
                  n_buckets=snap["n_buckets"], sample_cap=snap["sample_cap"])
    h._restore(_nan_safe(snap))
    return h


# Process-global registry for instruments that outlive any one scheduler
# (kernels/ops backend-dispatch counters, recorded once per program built).
# `Telemetry.snapshot(include_global=True)` merges it into a scheduler's
# snapshot; tests reset it via `GLOBAL.__init__()`-style `reset_global()`.
GLOBAL = MetricsRegistry()


def reset_global() -> None:
    GLOBAL._metrics.clear()
    GLOBAL._kinds.clear()
