"""Port parity: the flight recorder (`repro_torch.serve.flightrec`: events,
replay, diff) and the scheduler's decision events against the reference's.

The reference's `Scheduler` and the port's run the same workloads on the
CPU with converted weights (serve_conformance's reduced transformer case,
reference init, packed, f32), each recording: the main flow's mix of
greedy and "match"-sampled requests under async admission (prefix sharing
"auto"), the share workload with `prefill_chunk=page`, and the mix under
`SpecConfig(k=3)`.  `diff_records(reference, port)` must find the records
equal, event for event and field for field, after dropping only the
fields whose values differ by design (`BY_DESIGN`: the paged-attention
backend names of the `config` and `dispatch` events; the port's knob
takes "auto" / "cuda" / "torch", the reference's "auto" / "pallas" /
"interpret" / "off").  The port's own record replays event- and
token-identically, a perturbed run is named at its `dispatch` or `config`
event, the crash dump snapshots the pool and the requests, and the ring
buffer counts what it dropped.  The workload of
`examples/serve_hinm_torch.py` is the reference example's.
"""
import importlib.util
import json
import os
import unittest.mock

import jax
import numpy as np
import pytest

import serve_conformance as sc
from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.models import zoo as jzoo
from repro_torch import perf_knobs, serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import params_from_numpy
from repro_torch.serve.flightrec import (FlightEvent, as_events, load_jsonl, recorded_tokens,
                                         requests_from_record)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# event fields whose values differ between the packages by design: the
# paged-attention backend the knob asked for, resolved to, or deferred
BY_DESIGN = {"config": ("paged_attn",), "dispatch": ("requested", "backend", "defer")}
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _drop_by_design(record):
    return [FlightEvent(ev.seq, ev.kind, ev.t,
                        {k: v for k, v in ev.data.items() if k not in BY_DESIGN.get(ev.kind, ())})
            for ev in as_events(record)]


@pytest.fixture(scope="module")
def setup():
    c = sc._CASES["transformer"]
    jcfg = jload_arch("qwen2_0_5b").reduced(**c["reduced"])
    cfg = load_arch("qwen2_0_5b").reduced(**c["reduced"])
    packed = jax.jit(jzoo.pack_params, static_argnums=0)(
        jcfg, jax.jit(jzoo.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, packed), "cpu")
    with unittest.mock.patch.object(sc, "_model", lambda family: (jcfg, None)):
        share_prompts, _ = sc._share_workload.__wrapped__("transformer")
    return jcfg, cfg, packed, model, share_prompts, c


def _mix(mod, vocab, _):
    """Six requests over two slots, one a step: greedy ones and "match"-
    sampled ones (temperature, top-k, top-p, an explicit seed), around a
    repeated motif the n-gram drafter can hit."""
    rng = np.random.default_rng(29)
    motif = rng.integers(0, vocab, (3,)).astype(np.int32)
    reqs = []
    for i in range(6):
        p = mod.SamplingParams(max_new_tokens=10 if i % 2 == 0 else 6)
        if i in (1, 4):
            p.temperature, p.top_k, p.top_p, p.seed = 0.8, 16, 0.9, 40 + i
        tail = rng.integers(0, vocab, (2 + 2 * i,)).astype(np.int32)
        reqs.append(mod.Request(rid=i, prompt=np.concatenate([motif, tail, motif]),
                                params=p, arrival=i))
    return reqs


def _share(mod, _, prompts):
    return [mod.Request(rid=i, prompt=p, arrival=i, params=mod.SamplingParams(max_new_tokens=7))
            for i, p in enumerate(prompts)]


# workload -> (requests, scheduler arguments); spec=True -> SpecConfig(k=3)
RUNS = {
    "plain": (_mix, dict(max_slots=2, max_seq=64, page=16, decode_chunk=4)),
    "share": (_share, dict(max_slots=4, max_seq=sc.MAX_SEQ, page=16, decode_chunk=4,
                           prefix_share=True, prefill_chunk=16)),
    "spec": (_mix, dict(max_slots=2, max_seq=64, page=16, decode_chunk=4, spec=True)),
}


def _sched(mod, cfg, params, name, **kw):
    args = {**RUNS[name][1], "flightrec": True, **kw}
    if args.pop("spec", False):
        args["spec"] = mod.SpecConfig(k=3)
    return mod.Scheduler(cfg, params, **args)


def _run(mod, cfg, params, name, prompts, **kw):
    sched = _sched(mod, cfg, params, name, **kw)
    reqs = RUNS[name][0](mod, cfg.vocab, prompts)
    sched.run(reqs)
    return sched, reqs


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's recorded run of each workload (a fresh scheduler
    each, so each record opens with its `dispatch` and `config` events)."""
    jcfg, cfg, packed, _, prompts, _ = setup
    return {name: _run(jserve, jcfg, packed, name, prompts) for name in RUNS}


def _port(setup, name, **kw):
    _, cfg, _, model, prompts, _ = setup
    return _run(serve, cfg, model, name, prompts, device="cpu", **kw)


# the decisions each workload must have exercised
KINDS = {"plain": {"admit", "commit", "emit", "finish", "kv_acquire", "kv_insert",
                   "kv_release", "submit", "prefix_register"},
         "share": {"ext_admit", "chunk", "graduate", "kv_map", "kv_ref", "prefix_match",
                   "prefix_register"},
         "spec": {"spec_window", "emit", "commit"}}


@pytest.mark.parametrize("name", list(RUNS))
def test_record_equals_reference(setup, reference, name):
    jsched, jreqs = reference[name]
    sched, reqs = _port(setup, name)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    events = sched.flight.events
    assert [ev.kind for ev in events[:2]] == ["dispatch", "config"]
    assert KINDS[name] <= {ev.kind for ev in events}
    if name == "plain":
        assert any(ev.kind == "admit" and ev.data["overlap"] for ev in events)
    rep = serve.diff_records(_drop_by_design(jsched.flight.events),
                             _drop_by_design(sched.flight))
    assert rep.equal, rep.render()
    assert rep.n_a == rep.n_b == len(events)


@pytest.mark.parametrize("name", list(RUNS))
def test_own_record_replays(setup, name, tmp_path):
    sched, reqs = _port(setup, name)
    path = str(tmp_path / f"{name}.jsonl")
    sched.flight.dump(path)
    assert [ev.signature() for ev in load_jsonl(path)] == [
        ev.signature() for ev in sched.flight.events]
    rebuilt = requests_from_record(path)
    assert [(r.rid, r.arrival, r.prompt.tolist()) for r in rebuilt] == [
        (r.rid, r.arrival, r.prompt.tolist()) for r in reqs]
    assert recorded_tokens(path) == {r.rid: r.tokens for r in reqs}
    _, cfg, _, model, _, _ = setup
    rep = serve.replay(path, _sched(serve, cfg, model, name, device="cpu"))
    assert rep.ok, rep.render()
    rep.assert_equal()
    assert rep.n_requests == len(reqs) and rep.n_events == len(sched.flight)


def test_reference_record_replays_on_the_port(setup, reference, tmp_path):
    """On the CPU both packages resolve the paged-attention knob to "auto",
    so the reference's own record, read back from JSON lines, replays on
    the port event for event."""
    jsched, _ = reference["plain"]
    path = str(tmp_path / "reference.jsonl")
    jsched.flight.dump(path)
    _, cfg, _, model, _, _ = setup
    serve.replay(path, _sched(serve, cfg, model, "plain", device="cpu")).assert_equal()


def test_perturbed_runs_name_dispatch_or_config_first(setup):
    _, cfg, _, model, prompts, _ = setup
    base, _ = _port(setup, "plain")
    with perf_knobs.knobs(paged_attn="torch"):   # force the plain K2 path
        pert = _sched(serve, cfg, model, "plain", device="cpu")
    pert.run(_mix(serve, cfg.vocab, prompts))
    rep = serve.diff_records(base.flight, pert.flight)
    assert not rep.equal
    assert rep.first.stream == ("global",) and rep.first.index == 0
    assert rep.first.a.kind == rep.first.b.kind == "dispatch"
    assert (rep.first.a.data["requested"], rep.first.b.data["requested"]) == ("auto", "torch")
    assert "dispatch" in rep.render()
    # a replay on a scheduler built with another decode_chunk parts at config
    other = _sched(serve, cfg, model, "plain", device="cpu", decode_chunk=2)
    rep = serve.replay(base.flight.events, other)
    assert not rep.events_equal
    assert rep.diff.first.a.kind == rep.diff.first.b.kind == "config"
    assert rep.diff.first.a.data["decode_chunk"] == 4 != rep.diff.first.b.data["decode_chunk"]
    with pytest.raises(AssertionError, match="replay diverged"):
        rep.assert_equal()


def test_replay_rejects_stale_or_nonrecording_scheduler(setup):
    _, cfg, _, model, _, _ = setup
    sched, _ = _port(setup, "plain")
    with pytest.raises(ValueError, match="fresh"):
        serve.replay(sched.flight.events, sched)
    with pytest.raises(ValueError, match="flightrec=True"):
        serve.replay(sched.flight.events, _sched(serve, cfg, model, "plain", device="cpu",
                                                 flightrec=False))


def test_crash_dump_snapshots_pool_and_requests(setup, tmp_path):
    _, cfg, _, model, prompts, _ = setup
    sched = _sched(serve, cfg, model, "share", device="cpu", telemetry=True)
    assert sched.flight.tracer is sched.telemetry.tracer   # instants bridge to the trace
    sched.flight.crash_path = str(tmp_path / "crash.json")
    for r in _share(serve, cfg.vocab, prompts)[:3]:
        sched.submit(r)
    for _ in range(3):
        sched.step()   # mid-prefill and decoding slots, mapped pages

    def explode(finished):
        raise RuntimeError("injected mid-step failure")

    sched._decode_and_harvest = explode
    with pytest.raises(RuntimeError, match="injected"):
        sched.step()
    crash = sched.flight.crash
    assert "injected mid-step failure" in crash["error"]
    assert crash["requests"] and {"rid", "phase", "slot", "prefill_cursor", "n_prompt"} <= set(
        crash["requests"][0])
    assert {r["phase"] for r in crash["requests"]} <= {"queued", "prefilling", "decoding",
                                                       "pending_commit"}
    pool = crash["pool"]
    assert pool["paged"] and len(pool["page_ref"]) == pool["n_pages"]
    assert pool["block_tables"]
    live = {p for pages in pool["block_tables"].values() for p in pages}
    assert all(pool["page_ref"][p] >= 1 for p in live)
    assert pool["n_free_pages"] + pool["n_referenced_pages"] == pool["n_pages"] - 2
    assert sorted(pool["free_pages"][0]) == sorted(sched.kv._free_pages)
    assert crash["prefix_index_pages"] == sched.prefix.n_pages
    assert crash["events_tail"] and crash["events_dropped"] == 0
    with open(sched.flight.crash_path) as f:
        assert json.load(f)["error"] == crash["error"]
    # the exception path closed every span; the trace carries the instants
    assert all(s.t1 is not None for s in sched.telemetry.tracer.events)
    assert len(sched.telemetry.tracer.instants) == sched.flight.seq


def test_ring_buffer_counts_dropped_and_recorder_wiring(setup):
    rec = serve.FlightRecorder(capacity=8)
    for i in range(20):
        rec.emit("tick", i=i)
    assert (len(rec), rec.seq, rec.dropped) == (8, 20, 12)
    assert [ev.data["i"] for ev in rec.events] == list(range(12, 20))
    with pytest.raises(ValueError):
        serve.FlightRecorder(capacity=0)
    a = FlightEvent(0, "admit", 1.0, {"group": [1, 2], "bucket": 8})
    b = FlightEvent(5, "admit", 99.0, {"bucket": 8, "group": [1, 2]})
    assert a.signature() == b.signature()    # wall clock and seq excluded
    _, cfg, _, model, _, _ = setup
    kw = dict(max_slots=2, max_seq=64, page=16, device="cpu")
    assert serve.Scheduler(cfg, model, **kw).flight is None
    shared = serve.FlightRecorder()
    assert serve.Scheduler(cfg, model, flightrec=shared, **kw).flight is shared


def _example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shared_prefix", [0, 24])
def test_example_workload_matches_reference_example(setup, shared_prefix):
    jcfg, cfg, _, _, _, _ = setup
    ours = _example("serve_hinm_torch").build_workload(
        cfg, 10, 32, np.random.default_rng(0), shared_prefix=shared_prefix)
    theirs = _example("serve_hinm").build_workload(
        jcfg, 10, 32, np.random.default_rng(0), shared_prefix=shared_prefix)
    assert len(ours) == len(theirs) == 10
    for a, b in zip(ours, theirs):
        assert (a.rid, a.arrival) == (b.rid, b.arrival)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert vars(a.params) == vars(b.params)
