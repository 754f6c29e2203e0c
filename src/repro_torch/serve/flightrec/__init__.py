"""Serving flight recorder (port of `repro.serve.flightrec`): structured
decision log, deterministic replay, and first-divergence triage.

Layered on (not replacing) the telemetry registry: metrics aggregate,
the flight recorder *attributes* — every admission, page, prefix, spec
and kernel-dispatch decision becomes a typed, causally-keyed event that
can be exported (JSON lines), replayed (`replay`), and diffed against
another run (`diff_records`) down to the first diverging decision.

Off by default (`Scheduler(flightrec=...)`); see `events.py` for the
recorder, `replay.py` for deterministic re-execution, `diff.py` for
triage.
"""
from repro_torch.serve.flightrec.diff import DiffReport, Divergence, diff_records
from repro_torch.serve.flightrec.events import (FlightEvent, FlightRecorder,
                                          as_events, load_jsonl,
                                          resolve_flightrec)
from repro_torch.serve.flightrec.replay import (ReplayReport, recorded_tokens,
                                          replay, requests_from_record)

__all__ = [
    "DiffReport",
    "Divergence",
    "FlightEvent",
    "FlightRecorder",
    "ReplayReport",
    "as_events",
    "diff_records",
    "load_jsonl",
    "recorded_tokens",
    "replay",
    "requests_from_record",
    "resolve_flightrec",
]
