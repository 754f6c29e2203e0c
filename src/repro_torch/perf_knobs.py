"""Process-wide knobs (port of `repro.perf_knobs`): the two the serving
path reads and the one the training attention reads.  The reference's
`xent_chunk`, `kv_block` and `q_block` are read nowhere in it, so they
have no port; the distributed knobs come with their slice (ROADMAP Queue 1
item 10).

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
    # Causal block skipping in training attention (`layers._attn_chunked`
    # with ``aligned``): query chunk i attends only to the static prefix of
    # KV blocks its causal (and window) mask reaches, instead of every
    # block with the rest masked.  Off by default, as the reference's.
    causal_block_skip: bool = False


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
