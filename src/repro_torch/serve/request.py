"""Request lifecycle model for the serving runtime (port of
`repro.serve.request`).

A `Request` moves through QUEUED -> PREFILLING -> DECODING -> FINISHED.
The scheduler owns the transitions; this module defines the data model
and the per-request / aggregate statistics: TTFT (submit -> first token),
decode tokens/s, packed-weight bytes per decode token, and the
speculative-decoding counts (verify steps, drafts proposed and accepted).
The prefix-sharing and per-request weight-share statistics wait for their
slices.
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
    temperature: float = 0.0     # <= 0 -> greedy
    top_k: int = 0               # 0 -> full vocab
    top_p: float = 0.0           # <= 0 -> disabled (nucleus sampling)
    eos_id: int | None = None    # None -> cfg.eos_id (when in-vocab)
    # per-request RNG seed: the sampled stream depends only on (seed, token
    # index), never on slot assignment or co-residents. None -> rid.
    seed: int | None = None
    # --- speculative decoding (active only on a Scheduler(spec=...)) ---
    # draft tokens this request accepts per verify step: None -> the
    # scheduler's SpecConfig.k, 0 -> speculation off for this request (it
    # still rides the verify batch, one token per step)
    spec_k: int | None = None
    # acceptance rule for stochastic slots: "match" reproduces the exact
    # non-speculative sampled stream; "reject" is rejection sampling
    # (unbiased, a different stream).  Greedy slots always match exactly.
    spec_accept: str = "match"


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
    # --- speculative decoding (Scheduler(spec=...)) ---
    spec_verify_steps: int = 0     # verify forwards this request rode
    spec_proposed: int = 0         # draft tokens judged for it
    spec_accepted: int = 0         # draft tokens accepted (excl. the bonus)

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens (0 when never speculated)."""
        return self.spec_accepted / max(self.spec_proposed, 1)

    @property
    def tokens_per_verify_step(self) -> float:
        """Decode tokens emitted per verify forward (> 1 = speculation won)."""
        return (self.n_generated - 1) / max(self.spec_verify_steps, 1)

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
    # --- speculative decoding: one verify forward = one packed-weight read
    # that can emit up to k+1 tokens per slot ---
    verify_steps: int = 0          # batched verify forwards executed
    lane_verify_steps: int = 0     # sum over slots of verifies they rode
    draft_proposed: int = 0
    draft_accepted: int = 0
    # host time of the unfused chain's draft proposals (a slice of
    # decode_seconds; the fused loop drafts inside its cycles, so 0 there)
    spec_draft_seconds: float = 0.0
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
    def acceptance_rate(self) -> float:
        return self.draft_accepted / max(self.draft_proposed, 1)

    @property
    def tokens_per_verify_step(self) -> float:
        """Tokens a slot emits per verify it rode (1 = no speculation win,
        k+1 = every draft accepted)."""
        return self.decode_tokens / max(self.lane_verify_steps, 1)

    @property
    def weight_bytes_per_accepted_token(self) -> float:
        """Packed-weight bytes read per decode token under speculation: one
        packed read per verify step over every token it emitted."""
        return self.packed_param_bytes * self.verify_steps / max(self.decode_tokens, 1)

    @property
    def weight_bytes_per_token(self) -> float:
        """Packed-weight bytes read per decode-emitted token: one full packed
        read per decode step, amortised over the tokens the batch emitted."""
        return self.packed_param_bytes * self.decode_steps / max(self.decode_tokens, 1)
