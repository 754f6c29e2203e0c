"""First-divergence triage between two flight records (port of
`repro.serve.flightrec.diff`).

`diff_records(a, b)` answers: two runs disagreed — *which decision
diverged first?*  A port record against a reference record of the same
workload names the first decision where the port parts from the
reference.  Events are
partitioned into causal streams (per-`rid`, per-`slot`, global) so that
interleave differences from scheduling noise don't mask the real
divergence: within each stream events are compared pairwise in order,
and the divergence with the lowest sequence number across all streams is
reported with surrounding context from both records.

Comparison uses `FlightEvent.signature()` — kind plus payload, wall
clock excluded — so identical decisions made at different speeds
compare equal, and the first *decision* difference (a different backend
resolution, a different admission group, a different accept count) is
what surfaces.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serve.flightrec.events import FlightEvent, as_events


@dataclasses.dataclass
class Divergence:
    """One stream's first disagreement. `a`/`b` is None when that record's
    stream ended early (a missing event is itself the divergence)."""
    stream: tuple
    index: int                     # position within the stream
    a: FlightEvent | None
    b: FlightEvent | None
    context_a: list[FlightEvent]   # events preceding the divergence (a)
    context_b: list[FlightEvent]

    @property
    def seq(self) -> int:
        """Global order of this divergence (min of the two records')."""
        seqs = [ev.seq for ev in (self.a, self.b) if ev is not None]
        return min(seqs) if seqs else 0

    def describe(self) -> str:
        def fmt(ev):
            if ev is None:
                return "<stream ended>"
            body = ", ".join(f"{k}={v!r}" for k, v in ev.data.items())
            return f"{ev.kind}({body}) [seq {ev.seq}]"

        key = "/".join(str(p) for p in self.stream)
        return (f"stream {key} event #{self.index}:\n"
                f"  a: {fmt(self.a)}\n"
                f"  b: {fmt(self.b)}")


@dataclasses.dataclass
class DiffReport:
    equal: bool
    n_a: int
    n_b: int
    n_streams: int
    first: Divergence | None       # lowest-seq divergence, None when equal
    divergences: list[Divergence]  # one per diverging stream, seq order

    def render(self) -> str:
        """Human-readable triage report (the conformance artifact body)."""
        lines = [f"flight-record diff: {self.n_a} vs {self.n_b} events, "
                 f"{self.n_streams} causal streams"]
        if self.equal:
            lines.append("records are event-for-event identical")
            return "\n".join(lines)
        lines.append(f"{len(self.divergences)} diverging stream(s); "
                     f"first divergence:")
        lines.append(self.first.describe())
        if self.first.context_a or self.first.context_b:
            lines.append("context (a):")
            for ev in self.first.context_a:
                lines.append(f"  {ev!r}")
            lines.append("context (b):")
            for ev in self.first.context_b:
                lines.append(f"  {ev!r}")
        others = [d for d in self.divergences if d is not self.first]
        if others:
            lines.append("other diverging streams:")
            for d in others:
                lines.append("  " + d.describe().replace("\n", "\n  "))
        return "\n".join(lines)


def _streams(events: list[FlightEvent]) -> dict[tuple, list[FlightEvent]]:
    out: dict[tuple, list[FlightEvent]] = {}
    for ev in events:
        out.setdefault(ev.stream_key(), []).append(ev)
    return out


def diff_records(a, b, context: int = 5) -> DiffReport:
    """Align two records by causal stream and report the first diverging
    event of each stream that disagrees.  `a`/`b` accept a
    `FlightRecorder`, an event list, or a JSONL path."""
    ea, eb = as_events(a), as_events(b)
    sa, sb = _streams(ea), _streams(eb)
    divergences: list[Divergence] = []
    for key in list(sa) + [k for k in sb if k not in sa]:
        la, lb = sa.get(key, []), sb.get(key, [])
        idx = None
        for i in range(min(len(la), len(lb))):
            if la[i].signature() != lb[i].signature():
                idx = i
                break
        if idx is None:
            if len(la) == len(lb):
                continue
            idx = min(len(la), len(lb))  # one stream ended early
        divergences.append(Divergence(
            stream=key, index=idx,
            a=la[idx] if idx < len(la) else None,
            b=lb[idx] if idx < len(lb) else None,
            context_a=la[max(0, idx - context):idx],
            context_b=lb[max(0, idx - context):idx]))
    divergences.sort(key=lambda d: d.seq)
    return DiffReport(
        equal=not divergences, n_a=len(ea), n_b=len(eb),
        n_streams=len(set(sa) | set(sb)),
        first=divergences[0] if divergences else None,
        divergences=divergences)
