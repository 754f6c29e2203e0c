"""Captured CUDA graphs of the serving runtime: the port's counterpart of
the reference scheduler's jitted programs (`Scheduler._build`).

A body is a closure without arguments that reads and writes only tensors
whose storage stays put (the scheduler's per-slot state, the KV pool,
static input and output buffers); every tensor it allocates dies with
the call.  `GraphCache.run(key, body)` runs it as key's graph:

  * the first use of a key runs the body eagerly: that run is served
    work and doubles as the warm-up (lazy library handles, the kernels'
    builds).  The graph is captured right after it; a capture records the
    launches and runs nothing, so live lanes do not advance twice;
  * every later use replays the graph.

All graphs of one cache share one memory pool: a replay runs on the
current stream after whatever was queued before it, so the graphs never
run concurrently and may reuse each other's intermediate memory.

On a CPU device the body runs eagerly every time (the caller chose that
device), and so does every body inside the private `_eager()` block,
the counterpart of `jax.disable_jit` that chip_smoke's graphed-vs-eager
gate uses.  A capture or replay that fails raises.

The kernels count their launches in Python, so a replay would add
nothing to ``hinm_spmm.launches`` and the others: the cache records each
counter's increase during capture, takes it back (a capture launches
nothing on the device) and adds it on every replay.  The counters keep
meaning "kernel launches the device ran".
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import hinm_spmm, nm_select, paged_attn

# every kernel wrapper's launch counter
_COUNTERS = (hinm_spmm.hinm_spmm, paged_attn.paged_decode_attn, nm_select.nm_select)
_run_eager = False


@contextlib.contextmanager
def _eager():
    """Run every graph body eagerly inside the block (no capture, no
    replay); graphs captured before stay cached.  Private: chip_smoke's
    gate holds graphed streams against this eager twin."""
    global _run_eager
    prev, _run_eager = _run_eager, True
    try:
        yield
    finally:
        _run_eager = prev


class GraphCache:
    """Keyed CUDA graphs over one shared memory pool (see the module
    docstring).  ``captures`` and ``replays`` count what it did."""

    def __init__(self, device: torch.device):
        self.device = device
        self._graphs: dict = {}
        self._pool = None
        self.captures = 0
        self.replays = 0

    def run(self, key, body) -> None:
        """Run `body` as the graph of `key`: eagerly (then captured) on its
        first use, replayed after."""
        if self.device.type != "cuda" or _run_eager:
            body()
            return
        entry = self._graphs.get(key)
        if entry is None:
            body()
            self._graphs[key] = self._capture(body)
            return
        graph, deltas = entry
        graph.replay()
        for counter, n in zip(_COUNTERS, deltas):
            counter.launches += n
        self.replays += 1

    def _capture(self, body):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = [c.launches for c in _COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            body()
        deltas = [c.launches - n for c, n in zip(_COUNTERS, before)]
        for c, n in zip(_COUNTERS, before):
            c.launches = n
        self.captures += 1
        return graph, deltas
