"""Speculative decoding for the serving runtime (port of `repro.serve.spec`;
`Scheduler(spec=...)`).

Decode reads the whole packed model to emit one token per slot.
Speculation flips the ratio: a drafter (n-gram lookup, or a paired small
model) guesses ``k`` tokens per slot (`drafter.py`), one multi-token
verify forward scores them all
(`verify.py` + `zoo.verify_step`), and the paged slot pool keeps the
accepted prefix while rolling the rejected suffix back
(`SlotKVCache.rollback`, or `zoo.cache_rollback` inside the fused loop).
Greedy and "match"-mode stochastic streams are token-identical to the
non-speculative ones.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serve.spec.drafter import (Drafter, ModelDrafter, NgramDrafter,
                                            append_history, ngram_propose,
                                            seed_history)
from repro_torch.serve.spec.verify import acceptance, position_keys

__all__ = [
    "Drafter",
    "ModelDrafter",
    "NgramDrafter",
    "SpecConfig",
    "acceptance",
    "append_history",
    "ngram_propose",
    "position_keys",
    "seed_history",
]


@dataclasses.dataclass
class SpecConfig:
    """Pool-level speculative-decoding configuration.

    ``k`` — draft tokens per verify step (verify width k + 1); a request
    lowers its own cap with `SamplingParams.spec_k` (0 = off for it; it
    still rides the verify batch at one token per step).
    ``drafter`` — "ngram" (host-free prompt lookup), "model" (the target's
    `draft_arch` pairing with random weights on the scheduler's device), or
    a `Drafter` instance (the way to supply real draft weights or a reduced
    config).
    ``ngram`` — lookup n-gram order of the "ngram" drafter.
    ``fused`` — run every cycle of a scheduler step (draft, verify, accept,
    rollback, history append) on the device with one host sync per step;
    False runs the per-cycle chain (propose, verify, `SlotKVCache.rollback`),
    token-identical by contract.
    ``cycles`` — draft/verify cycles per scheduler step; None derives it:
    ``decode_chunk`` fused, ``max(1, decode_chunk // (k + 1))`` unfused.
    """

    k: int = 4
    drafter: object = "ngram"
    ngram: int = 2
    fused: bool = True
    cycles: int | None = None
