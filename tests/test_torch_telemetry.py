"""Port parity: serving telemetry (`repro_torch.serve.telemetry`, the
scheduler's instruments, `kernels/ops` dispatch counters) against
`repro.serve.telemetry` and the reference scheduler.

The registry and the tracer are fed the same numpy inputs on both sides:
histogram percentiles, Prometheus text and snapshots are equal, a restore
round-trips, and the Chrome trace passes the reference's validity checks
(`tests/test_telemetry.py`).  On reduced qwen2-0.5b with converted weights
(f32, CPU) telemetry on and off give the same tokens, and one workload
(the share workload of `tests/serve_conformance.py` and two short
prompts, async admission, prefix sharing, chunked prefill of one page)
registers the same
instruments in both schedulers, with equal deterministic values: requests,
tokens, decode steps, prefill programs built, prefix hit tokens, chunks,
copy-on-write copies and overlap admissions.  Kernel dispatch decisions
count once per program built, never per step.
"""
import json
import math
import unittest.mock

import jax
import numpy as np
import pytest
import torch

import serve_conformance as sc
from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.models import zoo as jzoo
from repro.serve import telemetry as jtelemetry
from repro_torch import perf_knobs, serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import params_from_numpy
from repro_torch.serve import telemetry
from repro_torch.serve.telemetry import metrics as tm
from test_telemetry import _validate_chrome_trace
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# ---------------------------------------------------------------------------
# the registry on the same inputs
# ---------------------------------------------------------------------------


def _samples(dist, n):
    rng = np.random.default_rng(5)
    if dist == "lognormal":
        return rng.lognormal(-7.0, 1.5, n)
    if dist == "uniform":
        return rng.uniform(1e-5, 2e-2, n)
    return np.full(n, 3e-3)


@pytest.mark.parametrize("cap", [8192, 64], ids=["exact", "beyond-cap"])
@pytest.mark.parametrize("dist", ["lognormal", "uniform", "constant"])
def test_histogram_percentiles_match_reference(dist, cap):
    """Exact percentiles under the sample cap, the log-bucket estimate
    past it (and the weighted observe): equal to the reference's."""
    vals = _samples(dist, 500)
    hs = [mod.Histogram("lat", lo=1e-6, growth=2.0, n_buckets=40, sample_cap=cap)
          for mod in (tm, jtelemetry.metrics)]
    for h in hs:
        for v in vals:
            h.observe(v)
        h.observe(float(vals[0]), n=7)
    qs = (0, 1, 25, 50, 90, 99, 100)
    got, want = ([h.percentile(q) for q in qs] for h in hs)
    assert got == want
    assert (hs[0].exact, hs[0].count, hs[0].sum, hs[0].min, hs[0].max) == (
        hs[1].exact, hs[1].count, hs[1].sum, hs[1].min, hs[1].max)
    if cap == 8192:
        np.testing.assert_allclose(got[1:-1], np.percentile(
            np.concatenate([vals, np.full(7, vals[0])]), qs[1:-1]), rtol=0)


def _populate(mod):
    """The same instruments and observations on `mod.MetricsRegistry`."""
    reg = mod.MetricsRegistry()
    reg.counter("reqs").inc(7)
    reg.counter("dispatch", labels={"decision": "kernel"}).inc()
    reg.counter("dispatch", labels={"decision": "plain"}).inc(3)
    g = reg.gauge("free_pages", labels={"pool": "main"})
    for v in (10, 3, 8):
        g.set(v)
    h = reg.histogram("lat", labels={"phase": "decode", "q": 'a"b'})
    for v in _samples("lognormal", 40):
        h.observe(v)
    reg.histogram("accept", lo=1e-4, growth=1.2, n_buckets=50).observe(0.5, n=3)
    reg.histogram("empty")
    return reg


def test_registry_snapshot_prometheus_and_restore_match_reference():
    reg, jreg = _populate(tm), _populate(jtelemetry.metrics)
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    assert reg.render_prometheus() == jreg.render_prometheus()
    assert reg.to_json() == jreg.to_json()
    # a restore round-trips, from the reference's JSON too, and stays live
    for src in (snap, json.dumps(jreg.snapshot())):
        restored = tm.MetricsRegistry.from_snapshot(src)
        assert restored.snapshot() == snap
        assert restored.render_prometheus() == jreg.render_prometheus()
    g = restored.gauge("free_pages", labels={"pool": "main"})
    assert (g.value, g.min, g.max) == (8, 3, 10)
    e = restored.histogram("empty")
    assert e.count == 0 and math.isnan(e.min)
    h = tm.histogram_from_snapshot(snap["metrics"][4])
    assert h.percentiles() == jreg.get("lat", {"phase": "decode", "q": 'a"b'}).percentiles()


def test_registry_identity_and_kind_conflicts():
    reg = tm.MetricsRegistry()
    assert reg.counter("a") is reg.counter("a")
    assert reg.counter("a", {"x": "1"}) is not reg.counter("a", {"x": "2"})
    assert reg.get("missing") is None and reg.value("missing", default=5) == 5
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("a")
    tm.GLOBAL.counter("probe").inc()
    tm.reset_global()
    assert len(tm.GLOBAL) == 0


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def _trace(mod, request_cls):
    """The same spans, an open (abandoned) span and a flight instant on
    `mod.TraceRecorder`, at fixed offsets from its epoch."""
    tr = mod.TraceRecorder()
    t = tr.epoch
    tr.span("scheduler", "prefill[b8]", t + 0.001, t + 0.004, requests=2)
    tr.span("scheduler", "decode_chunk", t + 0.004, t + 0.009, steps=4)
    req = request_cls(rid=3, prompt=np.arange(4, dtype=np.int32))
    tr.request_span(req, "queued", t + 0.0005, t + 0.001)
    done = tr.begin("req3", "decode", t + 0.004, rid=3)
    tr.end(done, t + 0.009, tokens=4)
    tr.begin("req4", "decode", t + 0.006, rid=4)
    tr.instant("flightrec", "commit", t + 0.004, rid=3, slot=0, first=np.int32(7))
    return tr, req


def test_chrome_trace_matches_reference_and_is_valid(tmp_path):
    (tr, req), (jtr, _) = _trace(telemetry, serve.Request), _trace(jtelemetry, jserve.Request)
    assert [s.name for s in req.spans] == ["queued"]
    doc, jdoc = tr.chrome_trace(), jtr.chrome_trace()
    _validate_chrome_trace(doc)
    # the same events; only the process name differs (the package)
    assert doc["traceEvents"][0]["args"]["name"] == "repro_torch.serve"
    assert doc["traceEvents"][1:] == jdoc["traceEvents"][1:]
    assert [e for e in tr.events if e.args.get("auto_closed")]
    assert tr.finalize() == 0
    path = tmp_path / "trace.json"
    tr.dump(str(path))
    _validate_chrome_trace(json.loads(path.read_text()))


def test_annotation_is_the_torch_profiler_bridge():
    """Off: a null context.  On: a `record_function` range the profiler
    sees under the span's name (`name[step]` with a step)."""
    off = telemetry.Telemetry(enabled=True)
    with off.annotation("serve_decode_chunk", step=0) as ctx:
        assert ctx is None
    on = telemetry.Telemetry(enabled=True, annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with on.annotation("serve_decode_chunk", step=8):
            torch.ones(4).sum()
        with on.annotation("serve_prefill"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"serve_decode_chunk[8]", "serve_prefill"} <= names


def test_resolve_telemetry_and_knob():
    t = telemetry.Telemetry(enabled=False)
    assert telemetry.resolve_telemetry(t) is t
    assert telemetry.resolve_telemetry(None).enabled is False
    assert telemetry.resolve_telemetry(True).enabled is True
    with perf_knobs.knobs(telemetry=True):
        assert telemetry.resolve_telemetry("auto").enabled is True
    assert perf_knobs.KNOBS.telemetry is False


# ---------------------------------------------------------------------------
# the scheduler's instruments, reference vs port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def share():
    """serve_conformance's transformer case (reference init, packed, f32) on
    both sides, and its share workload with two short prompts appended
    (under one chunk: they take the group prefill)."""
    c = sc._CASES["transformer"]
    jcfg = jload_arch("qwen2_0_5b").reduced(**c["reduced"])
    cfg = load_arch("qwen2_0_5b").reduced(**c["reduced"])
    packed = jax.jit(jzoo.pack_params, static_argnums=0)(
        jcfg, jax.jit(jzoo.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, packed), "cpu")
    with unittest.mock.patch.object(sc, "_model", lambda family: (jcfg, None)):
        prompts, _ = sc._share_workload.__wrapped__("transformer")
    rng = np.random.default_rng(17)
    prompts = list(prompts) + [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
                               for n in (6, 11)]
    return jcfg, cfg, packed, model, prompts, c


def _sched(mod, cfg, params, c, **kw):
    return mod.Scheduler(cfg, params, max_slots=4, max_seq=sc.MAX_SEQ, decode_chunk=4,
                         page=c["page"], n_pages="auto", prefill_chunk=c["page"], **kw)


# the short prompts arrive while the shared ones decode, so one is
# admitted under a chunk in flight
ARRIVAL = (0, 1, 2, 3, 4, 2, 3)


def _requests(mod, prompts, c):
    # rid 3 samples ("match"), the rest are greedy
    return [mod.Request(rid=i, prompt=p, arrival=ARRIVAL[i], params=mod.SamplingParams(
        max_new_tokens=c["max_new"], temperature=0.8 if i == 3 else 0.0, top_k=8, seed=11))
        for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def reference_run(share):
    jcfg, _, packed, _, prompts, c = share
    sched = _sched(jserve, jcfg, packed, c, telemetry=True)
    reqs = _requests(jserve, prompts, c)
    sched.run(reqs)
    return sched, reqs


def _names(snap):
    return sorted((m["name"], tuple(sorted(m["labels"].items()))) for m in snap["metrics"])


# deterministic registry values: must be integer-equal to the reference's
COUNTED = ("serve_prefill_traces", "serve_prefix_hit_tokens", "serve_prefill_chunks",
           "serve_overlap_admissions", "serve_inflight_syncs", "serve_prefix_evictions",
           "serve_spec_dispatches", "kv_cow_copies", "kv_rollback_sweeps")
COUNTS = ("serve_admission_wait_seconds", "serve_decode_step_seconds",
          "serve_host_gap_seconds")


def test_registry_matches_reference_scheduler(share, reference_run):
    _, cfg, _, model, prompts, c = share
    jsched, jreqs = reference_run
    sched = _sched(serve, cfg, model, c, telemetry=True, device="cpu")
    reqs = _requests(serve, prompts, c)
    sched.run(reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    snap, jsnap = sched.metrics_snapshot(), jsched.metrics_snapshot()
    assert snap["enabled"] is jsnap["enabled"] is True
    assert _names(snap) == _names(jsnap)
    reg, jreg = sched.telemetry.registry, jsched.telemetry.registry
    for name in COUNTED:
        assert reg.value(name) == jreg.value(name), name
    for name in COUNTS:
        assert reg.get(name).count == jreg.get(name).count, name
    # requests, tokens and steps behind those counts
    assert reg.get("serve_admission_wait_seconds").count == len(reqs)
    assert reg.get("serve_decode_step_seconds").count == sched.stats.decode_steps
    assert sched.stats.tokens_generated == jsched.stats.tokens_generated
    # the workload engaged every counted path
    for name in ("serve_prefill_traces", "serve_prefix_hit_tokens", "serve_prefill_chunks",
                 "serve_overlap_admissions", "kv_cow_copies"):
        assert reg.value(name) > 0, name
    assert reg.value("serve_inflight_syncs") == 0
    # per-bucket histograms: the same bucket labels and counts
    for m in jsnap["metrics"]:
        if m["name"] in ("serve_prefill_seconds", "serve_prefill_chunk_seconds"):
            assert reg.get(m["name"], m["labels"]).count == m["count"], m
    # pool gauges: drained, with the low-water mark below the start
    assert reg.gauge("kv_slots_in_use").value == 0
    assert reg.gauge("kv_slots_in_use").max == jreg.gauge("kv_slots_in_use").max
    free, jfree = reg.gauge("kv_free_pages"), jreg.gauge("kv_free_pages")
    assert (free.value, free.min, free.max) == (jfree.value, jfree.min, jfree.max)
    assert reg.gauge("kv_pool_bytes").value == sched.kv.pool_bytes()
    # every request has closed lifecycle spans and the trace is valid
    assert all(any(s.name == "decode" for s in r.spans) for r in reqs if r.n_generated > 1)
    assert all(s.t1 is not None for r in reqs for s in r.spans)
    assert [[s.name for s in r.spans] for r in reqs] == [
        [s.name for s in r.spans] for r in jreqs]
    _validate_chrome_trace(sched.telemetry.tracer.chrome_trace())


def test_telemetry_on_off_tokens_identical(share):
    _, cfg, _, model, prompts, c = share
    runs = {}
    for mode in (False, True):
        sched = _sched(serve, cfg, model, c, telemetry=mode, flightrec=mode, device="cpu")
        reqs = _requests(serve, prompts, c)
        sched.run(reqs)
        runs[mode] = [r.tokens for r in reqs]
        assert sched.telemetry.enabled is mode
        assert bool(sched.telemetry.tracer.events) is mode
        # always counted, whether or not telemetry records time
        assert sched.telemetry.registry.value("serve_prefill_traces") > 0
    assert runs[True] == runs[False]


def test_dispatch_counts_once_per_program_built(share):
    """`paged_attn_dispatch` counts the decisions of the programs built
    (each chunk program calls K2 once per layer per step), whatever the
    number of steps: a second run on the same scheduler adds nothing."""
    _, cfg, _, model, prompts, c = share
    tm.reset_global()
    sched = _sched(serve, cfg, model, c, device="cpu")
    sched.run(_requests(serve, prompts, c))
    label = {"decision": "plain", "reason": "auto-cpu"}
    n = tm.GLOBAL.value("paged_attn_dispatch", label)
    built = sched.graphs._built
    chunks = sum(k[0] == "chunk" for k in built)
    extends = sum(k[0] == "extend" for k in built)
    assert chunks and extends
    assert n == cfg.n_layers * (sched.decode_chunk * chunks + extends)
    assert sched.stats.decode_steps > sched.decode_chunk * chunks   # steps outnumber programs
    assert sched.telemetry.registry.value("serve_prefill_traces") == sum(
        k[0] == "prefill" for k in built)
    sched.reset()
    sched.run(_requests(serve, prompts, c))
    assert tm.GLOBAL.value("paged_attn_dispatch", label) == n
    # a forced plain backend counts under its own reason; the dispatch
    # event names what was asked for and what runs
    tm.reset_global()
    with perf_knobs.knobs(paged_attn="torch"):
        forced = _sched(serve, cfg, model, c, device="cpu", flightrec=True)
    forced.run(_requests(serve, prompts, c)[:2])
    assert tm.GLOBAL.value("paged_attn_dispatch", {"decision": "plain", "reason": "forced"})
    assert tm.GLOBAL.value("paged_attn_dispatch", label) is None
    ev = forced.flight.events[0]
    assert (ev.kind, ev.data["requested"], ev.data["backend"]) == ("dispatch", "torch", "torch")
    tm.reset_global()


def test_stripe_pool_defers_paged_attention(share):
    _, cfg, _, model, _, _ = share
    sched = serve.Scheduler(cfg, model, max_slots=2, max_seq=64, page=None, device="cpu",
                            flightrec=True)
    assert sched.paged_attn == "off"
    assert sched.telemetry.registry.value("serve_paged_attn_deferred",
                                          {"reason": "pool-not-paged"}) == 1
    assert sched.flight.events[0].data == {"requested": "auto", "backend": "off",
                                          "defer": "pool-not-paged"}
