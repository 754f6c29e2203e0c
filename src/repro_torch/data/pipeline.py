"""Deterministic synthetic LM data (port of `repro.data.pipeline`).

A structured, learnable token stream — a mixture of order-2 Markov chains
with per-sequence regime switching — rather than iid noise, so small
training runs show a real, falling loss and HiNM pruning and recovery
dynamics are visible.  The tables and every draw come from numpy with the
reference's seeds and calls, so a batch is bit-equal to the reference's;
the port hands it out as int64 tensors on `device`.

`batch(step, start, count)` is deterministic in (seed, step, start): each
host can materialise its own slice of the global batch with no traffic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_regimes: int = 4
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab, 4096)  # transition table cap
        self._v = v
        # sparse-ish row-stochastic transition tables, one per regime
        self._tables = []
        for _ in range(self.n_regimes):
            fan = 8
            nxt = rng.integers(0, v, size=(v, fan))
            logits = rng.normal(size=(v, fan)).astype(np.float32)
            p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
            self._tables.append((nxt, p))

    def _numpy_batch(self, step: int, start: int = 0, count: int | None = None) -> dict:
        """Host-local slice [start, start+count) of the global batch, as the
        reference's int32 numpy arrays."""
        count = count or self.global_batch
        rng = np.random.default_rng((self.seed, step, start))
        toks = np.empty((count, self.seq_len + 1), dtype=np.int32)
        regime = rng.integers(0, self.n_regimes, size=count)
        cur = rng.integers(0, self._v, size=count)
        for t in range(self.seq_len + 1):
            toks[:, t] = cur
            u = rng.random(count)
            for r in range(self.n_regimes):
                sel = regime == r
                if not sel.any():
                    continue
                nxt, p = self._tables[r]
                rows = cur[sel]
                # vectorised categorical draw via inverse-CDF
                k = (u[sel][:, None] > np.cumsum(p[rows], axis=-1)).sum(-1)
                cur[sel] = nxt[rows, np.minimum(k, nxt.shape[1] - 1)]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int, start: int = 0, count: int | None = None) -> dict:
        """`_numpy_batch`'s slice as int64 tensors on the data's device."""
        return {k: to_device(torch.from_numpy(v.astype(np.int64)), self._device)
                for k, v in self._numpy_batch(step, start, count).items()}

    def iterator(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
