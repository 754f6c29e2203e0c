"""Continuous-batching serving runtime (port of `repro.serve`): `Scheduler`
over a paged `SlotKVCache` with greedy and sampled requests, n-gram
speculative decoding (`SpecConfig`) and refcounted prefix sharing with
chunked prefill (`PrefixIndex`), its decode, prefill and extension
programs run as captured CUDA graphs (`graphs`) under double-buffered
admission, and the `ServeEngine` facade.
"""
from repro_torch.serve import sampler
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv import SlotKVCache
from repro_torch.serve.prefix import PrefixIndex, PrefixMatch
from repro_torch.serve.request import (Request, RequestState, SamplingParams,
                                       ServeStats)
from repro_torch.serve.scheduler import Scheduler, param_bytes
from repro_torch.serve.spec import NgramDrafter, SpecConfig

__all__ = ["NgramDrafter", "PrefixIndex", "PrefixMatch", "Request", "RequestState", "SamplingParams", "Scheduler",
           "ServeEngine", "ServeStats", "SlotKVCache", "SpecConfig", "param_bytes",
           "sampler"]
