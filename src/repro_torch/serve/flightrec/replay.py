"""Deterministic replay of a recorded serving run (port of
`repro.serve.flightrec.replay`).

A flight record fully determines the admission schedule: every request's
prompt, sampling parameters, seed and arrival step are captured in its
`submit` event, and everything downstream — bucket choices, group
boundaries, chunk boundaries, page draws, spec accept counts — is a pure
function of that schedule plus the scheduler configuration (the `config`
event).  `replay(record, scheduler)` rebuilds the workload from the
record, drives a fresh recording scheduler over it, and compares the new
event stream and token streams against the original, event for event and
token for token.

The caller constructs the replay scheduler (params cannot ride in a
JSON record); `requests_from_record` rebuilds the workload; the config
fingerprints are part of the event streams, so a mismatched scheduler
surfaces as the very first diverging event rather than a deep token
mystery.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.flightrec.diff import DiffReport, diff_records
from repro_torch.serve.flightrec.events import as_events
from repro_torch.serve.request import Request, SamplingParams


def requests_from_record(record) -> list[Request]:
    """Rebuild the workload a record captured: one fresh `Request` per
    `submit` event, carrying the identical prompt, sampling parameters
    and arrival step.  Embeds requests are not replayable (the modality
    tensors do not ride in a JSON record) and raise."""
    reqs = []
    for ev in as_events(record):
        if ev.kind != "submit":
            continue
        d = ev.data
        if d.get("embeds"):
            raise ValueError(
                f"request {d['rid']}: embeds requests cannot be rebuilt "
                "from a flight record (modality tensors are not recorded)")
        params = SamplingParams(
            max_new_tokens=d["max_new"], temperature=d["temperature"],
            top_k=d["top_k"], top_p=d["top_p"], eos_id=d["eos"],
            seed=d["seed"], spec_k=d["spec_k"], spec_accept=d["spec_accept"])
        reqs.append(Request(rid=d["rid"],
                            prompt=np.asarray(d["prompt"], np.int32),
                            params=params, arrival=d["arrival"]))
    return reqs


@dataclasses.dataclass
class ReplayReport:
    events_equal: bool
    tokens_equal: bool
    n_events: int                  # events in the reference record
    n_requests: int
    diff: DiffReport               # event-stream triage (first divergence)
    token_mismatches: list[tuple]  # (rid, recorded, replayed)

    @property
    def ok(self) -> bool:
        return self.events_equal and self.tokens_equal

    def render(self) -> str:
        lines = [f"replay: {self.n_requests} requests, "
                 f"{self.n_events} reference events"]
        lines.append(f"tokens: {'identical' if self.tokens_equal else f'{len(self.token_mismatches)} request(s) diverged'}")
        for rid, rec, got in self.token_mismatches[:5]:
            lines.append(f"  rid {rid}: recorded {rec} != replayed {got}")
        lines.append("events: " + ("identical" if self.events_equal
                                   else self.diff.first.describe()))
        return "\n".join(lines)

    def assert_equal(self) -> None:
        if not self.ok:
            raise AssertionError("replay diverged from record\n"
                                 + self.render())


def recorded_tokens(record) -> dict[int, list[int]]:
    """Per-request final token streams, from the record's `finish`
    events."""
    return {ev.data["rid"]: list(ev.data["tokens"])
            for ev in as_events(record) if ev.kind == "finish"}


def replay(record, scheduler, max_steps: int = 1_000_000) -> ReplayReport:
    """Re-execute a recorded run on `scheduler` (a freshly constructed
    scheduler with recording ON and the same configuration) and compare
    the replayed event and token streams against the record."""
    if getattr(scheduler, "flight", None) is None:
        raise ValueError("replay needs a recording scheduler — construct "
                         "it with flightrec=True")
    if any(ev.kind not in ("dispatch", "config")
           for ev in scheduler.flight.events):
        raise ValueError("replay needs a fresh scheduler: this one already "
                         "recorded workload events")
    ref = as_events(record)
    reqs = requests_from_record(ref)
    scheduler.run(reqs, max_steps=max_steps)
    if scheduler.flight.dropped or len(ref) > scheduler.flight.capacity:
        raise ValueError(
            "replay recorder overflowed its ring buffer "
            f"(capacity {scheduler.flight.capacity}); raise "
            "FlightRecorder(capacity=...) above the record length")
    diff = diff_records(ref, scheduler.flight.events)
    want = recorded_tokens(ref)
    mismatches = [(r.rid, want.get(r.rid), r.tokens) for r in reqs
                  if r.tokens != want.get(r.rid)]
    return ReplayReport(
        events_equal=diff.equal, tokens_equal=not mismatches,
        n_events=len(ref), n_requests=len(reqs), diff=diff,
        token_mismatches=mismatches)
