"""Continuous-batching serving runtime (port of `repro.serve`, synchronous
greedy path): `Scheduler` over a paged `SlotKVCache`, `ServeEngine` facade.
"""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv import SlotKVCache
from repro_torch.serve.request import (Request, RequestState, SamplingParams,
                                       ServeStats)
from repro_torch.serve.scheduler import Scheduler, param_bytes

__all__ = ["Request", "RequestState", "SamplingParams", "Scheduler",
           "ServeEngine", "ServeStats", "SlotKVCache", "param_bytes"]
