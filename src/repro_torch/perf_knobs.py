"""Process-wide knobs the serving path reads (port of the two serving knobs
of `repro.perf_knobs`; the distributed and training knobs come with their
slices, ROADMAP Queue 1 items 9 and 10).

`knobs(**overrides)` swaps in a modified copy for the duration of a
``with`` block, as the reference's does.
"""
from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class Knobs:
    # Paged-attention backend (kernels/ops.paged_attention): "auto" = the
    # K2 kernel on a CUDA tensor, its plain PyTorch version on a CPU one;
    # "cuda" = the kernel (raises on a CPU tensor); "torch" = the plain
    # version on any device.  A scheduler resolves it once, at construction.
    paged_attn: str = "auto"
    # Serving telemetry (serve/telemetry): False = only the instruments
    # counted once per program built (prefill programs, kernel dispatch
    # decisions); True = schedulers default to wall-clock histograms and
    # request-lifecycle tracing.  Per scheduler: Scheduler(telemetry=...).
    telemetry: bool = False


KNOBS = Knobs()


@contextlib.contextmanager
def knobs(**overrides):
    global KNOBS
    prev = KNOBS
    KNOBS = dataclasses.replace(KNOBS, **overrides)
    try:
        yield KNOBS
    finally:
        KNOBS = prev
