"""Token sampling for the serving runtime (port of `repro.serve.sampler`).

Greedy only.  The reference's stochastic sampling draws from JAX's
threefry PRNG (`fold_keys`, `jax.random.categorical`); whether the port
reproduces those bits or holds sampled streams to distribution tests is
still open (ROADMAP.md, Queue 1 item 5), so the Scheduler refuses
``temperature > 0``.
"""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, V) -> argmax token ids (B,) int32 (first maximum on ties,
    as `jnp.argmax`)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
