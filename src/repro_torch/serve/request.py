"""Request lifecycle model for the serving runtime (port of
`repro.serve.request`).

A `Request` moves through QUEUED -> PREFILLING -> DECODING -> FINISHED.
The scheduler owns the transitions; this module defines the data model
and the per-request / aggregate statistics: TTFT (submit -> first token),
decode tokens/s, and packed-weight bytes per decode token.  The
speculative, prefix-sharing and per-request weight-share statistics wait
for their slices.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.serve.telemetry.metrics import NAN, Histogram


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0     # <= 0 -> greedy (the only mode ported yet)
    eos_id: int | None = None    # None -> cfg.eos_id (when in-vocab)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                      # (S,) int32
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival: int = 0                        # scheduler step it becomes visible

    state: RequestState = RequestState.QUEUED
    slot: int | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    finish_reason: str | None = None        # "eos" | "length"

    submit_time: float = 0.0
    admit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def ttft(self) -> float:
        """Submit -> first token; NaN while no first token exists."""
        if not self.first_token_time or not self.submit_time:
            return NAN
        return self.first_token_time - self.submit_time

    @property
    def tokens_per_second(self) -> float:
        """Decode throughput (first token -> finish); NaN until finished."""
        if not self.finish_time or not self.first_token_time:
            return NAN
        span = self.finish_time - self.first_token_time
        return (self.n_generated - 1) / max(span, 1e-9)



@dataclasses.dataclass
class ServeStats:
    prefill_seconds: float
    decode_seconds: float
    tokens_generated: int
    packed_param_bytes: int
    dense_param_bytes: int
    requests_finished: int = 0
    finished_at_eos: int = 0
    decode_steps: int = 0          # batched decode steps executed
    # tokens emitted by decode chunks; excludes each request's first token,
    # which is sampled from prefill logits and timed under prefill_seconds
    decode_tokens: int = 0
    prefill_rows: int = 0          # prompt rows computed by prefill
    ttft_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("serve_ttft_seconds"))
    step_time_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("serve_decode_step_seconds"))

    def observe_finish(self, req: Request) -> None:
        """Fold a finished request's TTFT into its distribution."""
        if req.ttft == req.ttft:  # NaN-safe: unset timestamps never land
            self.ttft_hist.observe(req.ttft)

    def ttft_percentile(self, q: float) -> float:
        return self.ttft_hist.percentile(q)

    def step_time_percentile(self, q: float) -> float:
        return self.step_time_hist.percentile(q)

    @property
    def decode_tokens_per_second(self) -> float:
        return self.decode_tokens / max(self.decode_seconds, 1e-9)

    @property
    def weight_bytes_per_token(self) -> float:
        """Packed-weight bytes read per decode-emitted token: one full packed
        read per decode step, amortised over the tokens the batch emitted."""
        return self.packed_param_bytes * self.decode_steps / max(self.decode_tokens, 1)
