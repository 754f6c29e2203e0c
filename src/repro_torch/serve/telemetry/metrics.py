"""The port's copy of the latency histogram from `repro.serve.telemetry.metrics`
(numpy only; kept here so the port never imports the reference package).
The registry, exposition and tracing parts wait for the telemetry slice.
"""
from __future__ import annotations

import math

import numpy as np

NAN = float("nan")


class Histogram:
    """Log-bucketed distribution with exact-percentile extraction.

    Buckets are geometric: upper bounds ``lo * growth**i`` for
    ``i in [0, n_buckets)`` plus a final +inf overflow bucket; values
    ``<= lo`` land in bucket 0.  Raw samples are retained up to
    ``sample_cap`` so ``percentile`` is numpy-exact at test scale; past the
    cap it interpolates geometrically inside the covering bucket.
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

    def observe(self, v: float, n: int = 1) -> None:
        """Record `v` (`n` identical observations in one call)."""
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
        up = math.inf if i >= self.n_buckets else self.lo * self.growth ** i
        down = 0.0 if i == 0 else self.lo * self.growth ** (i - 1)
        return down, up

    @property
    def exact(self) -> bool:
        return self.count == len(self._samples)

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100); NaN for an empty histogram."""
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
