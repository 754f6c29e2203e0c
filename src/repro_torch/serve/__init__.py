"""Continuous-batching serving runtime (port of `repro.serve`): `Scheduler`
over a paged `SlotKVCache` with greedy and sampled requests, n-gram
speculative decoding (`SpecConfig`) and refcounted prefix sharing with
chunked prefill (`PrefixIndex`), its decode, prefill and extension
programs run as captured CUDA graphs (`graphs`) under double-buffered
admission, the `ServeEngine` facade, and its observability: telemetry
(`Telemetry`: metrics registry and Chrome-trace spans) and the flight
recorder (`FlightRecorder`, `replay`, `diff_records`).
"""
from repro_torch.serve import sampler
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.flightrec import (FlightEvent, FlightRecorder, diff_records,
                                         load_jsonl, replay, resolve_flightrec)
from repro_torch.serve.kv import SlotKVCache
from repro_torch.serve.prefix import PrefixIndex, PrefixMatch
from repro_torch.serve.request import (Request, RequestState, SamplingParams,
                                       ServeStats)
from repro_torch.serve.scheduler import Scheduler, param_bytes
from repro_torch.serve.spec import NgramDrafter, SpecConfig
from repro_torch.serve.telemetry import (MetricsRegistry, Telemetry, TraceRecorder,
                                         resolve_telemetry)

__all__ = ["FlightEvent", "FlightRecorder", "MetricsRegistry", "NgramDrafter", "PrefixIndex",
           "PrefixMatch", "Request", "RequestState", "SamplingParams", "Scheduler",
           "ServeEngine", "ServeStats", "SlotKVCache", "SpecConfig", "Telemetry",
           "TraceRecorder", "diff_records", "load_jsonl", "param_bytes", "replay",
           "resolve_flightrec", "resolve_telemetry", "sampler"]
