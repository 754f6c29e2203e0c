"""Port parity: speculative decoding with the model drafter
(`repro_torch.serve.spec.ModelDrafter`, the scheduler's draft pool and
programs) against `repro.serve`.

Target: reduced qwen2.5-14b; draft: reduced qwen2-0.5b (both 2 layers,
d_model 64, V 128, f32), its paired draft_arch.  The draft's weights are
the target's plus seeded noise, so about half its greedy proposals are
accepted.  The target's weights are seeded (the port's init, laid out as
the reference's params tree); both are packed by the reference and
carried across by `params_from_numpy`.

One reference `Scheduler(spec=SpecConfig(k=3, drafter=ModelDrafter(...)))`
run, recording and with telemetry on, serves a workload of greedy and
"match"-sampled requests under async admission, with prefix sharing and
`prefill_chunk=page`: short prompts take the group prefill, long ones the
chunked extension, later ones hit the shared prefix.  The reference's
fused and unfused streams are equal by its own tests, so this one run
serves both: the port's fused and unfused runs must give its token
streams and its ``draft_proposed`` / ``draft_accepted``; the port's fused
record must equal the reference's event for event (the draft pool's
events, ``pool: "draft"``, included) after dropping only the by-design
backend names, and the reference's record replays on a port scheduler;
the draft pool's labelled instruments equal the reference's.  Self-draft
(the target drafting for itself) must accept every proposal and emit k+1
tokens per verify, both pools drained, as the reference's
`tests/serve_conformance.py` `run_self_draft` and `tests/test_serve.py`
hold it.
"""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.models import zoo as jzoo
from repro_torch import serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import zoo as pzoo
from repro_torch.serve import spec as pspec
from repro_torch.serve.flightrec import FlightEvent, as_events
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16)
K = 3
# the draft = the target + this much seeded noise (of each leaf's own std)
NOISE = 0.03
# the requests with short prompts
SHORT = (1, 3, 6)
# the long prompts' tails past the base: every suffix left to prefill, after
# a hit on the base's 32 shared rows or in 16-row chunks, is 9-16 rows
TAIL = {0: 3, 2: 7, 4: 5, 5: 12}
SCHED = dict(max_slots=2, max_seq=64, page=16, decode_chunk=4, prefix_share=True,
             prefill_chunk=16)
# event fields whose values differ between the packages by design: the
# paged-attention backend names (tests/test_torch_flightrec.py)
BY_DESIGN = {"config": ("paged_attn",), "dispatch": ("requested", "backend", "defer")}
DRAFT_POOL = ("kv_slots_in_use", "kv_pool_bytes", "kv_rollback_sweeps")


def _drop_by_design(record):
    return [FlightEvent(ev.seq, ev.kind, ev.t,
                        {k: v for k, v in ev.data.items() if k not in BY_DESIGN.get(ev.kind, ())})
            for ev in as_events(record)]


@pytest.fixture(scope="module")
def setup():
    jtcfg, tcfg = jload_arch("qwen2_5_14b").reduced(**RED), load_arch("qwen2_5_14b").reduced(**RED)
    jdcfg, dcfg = jload_arch("qwen2_0_5b").reduced(**RED), load_arch("qwen2_0_5b").reduced(**RED)
    # seeded weights in the reference's params tree (the port's init, as
    # the reference lays it out), packed by the reference
    dense = jax.tree.map(lambda t: t.numpy(), pzoo.params_of(tcfg, pzoo.init(
        tcfg, torch.Generator().manual_seed(0), "cpu")))
    rng = np.random.default_rng(5)
    noisy = jax.tree.map(lambda a: a + NOISE * np.std(a) * rng.standard_normal(a.shape)
                         .astype(np.float32), dense)
    pack = jax.jit(jzoo.pack_params, static_argnums=0)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        tpacked, dpacked = ex.map(pack, (jtcfg, jdcfg), (dense, noisy))
    target = params_from_numpy(tcfg, jax.tree.map(np.asarray, tpacked), "cpu")
    draft = params_from_numpy(dcfg, jax.tree.map(np.asarray, dpacked), "cpu")
    return (jtcfg, jdcfg, tpacked, dpacked), (tcfg, dcfg, target, draft)


def _workload(mod, vocab, greedy_only=False, max_new=9):
    """Seven requests over two slots, one arriving a step: short prompts
    (one length bucket, the group prefill; "match"-sampled unless
    `greedy_only`) and greedy long ones over a shared 40-token base
    (chunked extensions, every chunk one width bucket; the later ones hit
    the base's two full pages).  The shapes keep the reference's programs
    few: it compiles one per bucket, width and flag."""
    rng = np.random.default_rng(71)
    base = rng.integers(0, vocab, (40,)).astype(np.int32)
    prompts = []
    for i in range(7):
        if i in SHORT:
            prompts.append(rng.integers(0, vocab, (4 + i // 2,)).astype(np.int32))
        else:
            tail = rng.integers(0, vocab, (TAIL[i],)).astype(np.int32)
            prompts.append(np.concatenate([base[: 40 if i % 2 == 0 else 32], tail]))
    reqs = []
    for i, p in enumerate(prompts):
        sp = mod.SamplingParams(max_new_tokens=max_new)
        if not greedy_only and i in SHORT:
            sp.temperature, sp.top_k, sp.top_p, sp.seed = 0.8, 16, 0.9, 30 + i
        reqs.append(mod.Request(rid=i, prompt=p, params=sp, arrival=i))
    return reqs


def _reference_run(setup):
    (jtcfg, jdcfg, tpacked, dpacked), _ = setup
    sched = jserve.Scheduler(
        jtcfg, tpacked, spec=jserve.SpecConfig(k=K, drafter=jserve.ModelDrafter(jdcfg, dpacked)),
        flightrec=True, telemetry=True, **SCHED)
    reqs = _workload(jserve, jtcfg.vocab)
    sched.run(reqs)
    return sched, reqs


def _port(setup, fused=True, drafter=None, **kw):
    _, (tcfg, dcfg, target, draft) = setup
    drafter = drafter or pspec.ModelDrafter(dcfg, draft)
    return serve.Scheduler(tcfg, target, spec=serve.SpecConfig(k=K, drafter=drafter, fused=fused),
                           device="cpu", **{**SCHED, **kw})


def _served(sched, **kw):
    reqs = _workload(serve, sched.cfg.vocab, **kw)
    sched.run(reqs)
    return sched, reqs


@pytest.fixture(scope="module")
def runs(setup):
    """The reference's recorded run, on a thread, beside the port's runs of
    the same workload (fused, recording and with telemetry on; unfused)
    and of the greedy self-draft one (fused, unfused, and without
    speculation)."""
    _, (tcfg, _, target, _) = setup
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ref = ex.submit(_reference_run, setup)
        out = {"fused": _served(_port(setup, flightrec=True, telemetry=True)),
               "unfused": _served(_port(setup, fused=False))}
        for fused in (True, False):
            out[f"self {fused}"] = _served(
                _port(setup, fused=fused, drafter=pspec.ModelDrafter(tcfg, target)),
                greedy_only=True)
        out["plain"] = _served(serve.Scheduler(tcfg, target, device="cpu", **SCHED),
                               greedy_only=True)
        out["reference"] = ref.result()
    return out


def _drained(sched):
    """Both pools hold no slot; the target's pages left are the prefix
    index's retained ones."""
    d, kv = sched.draft_kv, sched.kv
    assert d.n_free == d.n_slots and not d.slot_len.any()
    assert kv.n_free == kv.n_slots and not kv.slot_len.any() and kv.n_live_pages == 0
    assert kv.n_free_pages + kv.n_referenced_pages == kv.n_alloc_pages


@pytest.mark.parametrize("fused", [True, False])
def test_streams_and_acceptance_equal_reference(runs, fused):
    jsched, jreqs = runs["reference"]
    sched, reqs = runs["fused" if fused else "unfused"]
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    st, jst = sched.stats, jsched.stats
    assert (st.draft_proposed, st.draft_accepted) == (jst.draft_proposed, jst.draft_accepted)
    assert [(r.spec_proposed, r.spec_accepted) for r in reqs] == [
        (r.spec_proposed, r.spec_accepted) for r in jreqs]
    # the workload rode every path: accepts and rejects, hits, chunks, groups
    assert 0 < st.acceptance_rate < 1
    assert st.prefix_hit_tokens > 0 and st.prefill_chunks > 0
    assert any(r.params.temperature > 0 for r in reqs)
    cycles = st.verify_steps
    assert sched.draft_kv.rollback_sweeps == sched.kv.rollback_sweeps == cycles
    dispatches = sched.telemetry.registry.value("serve_spec_dispatches")
    assert dispatches == (cycles // sched._spec_cycles if fused else 4 * cycles)
    _drained(sched)


def test_record_and_draft_pool_instruments_equal_reference(setup, runs, tmp_path):
    jsched, _ = runs["reference"]
    sched, _ = runs["fused"]
    events = sched.flight.events
    draft_kinds = {ev.kind for ev in events if ev.data.get("pool") == "draft"}
    assert {"kv_acquire", "kv_insert", "kv_release"} <= draft_kinds
    rep = serve.diff_records(_drop_by_design(jsched.flight.events), _drop_by_design(events))
    assert rep.equal, rep.render()
    for name in DRAFT_POOL:
        got = sched.telemetry.registry.get(name, {"pool": "draft"})
        want = jsched.telemetry.registry.get(name, {"pool": "draft"})
        assert got is not None and got.snapshot() == want.snapshot(), name
    # the reference's record, read back, replays on a fresh port scheduler
    path = str(tmp_path / "reference.jsonl")
    jsched.flight.dump(path)
    serve.replay(path, _port(setup, flightrec=True)).assert_equal()


def test_crash_dump_snapshots_the_draft_pool(setup):
    """The crash dump carries the draft pool; the draft pool's storage
    keeps its addresses through inserts, rollbacks, a crash and `reset()`
    (captured graphs hold them)."""
    sched = _port(setup, flightrec=True)
    ptrs = {name: t.data_ptr() for name, t in sched.draft_kv.cache.items()}
    for r in _workload(serve, sched.cfg.vocab)[:3]:
        sched.submit(r)
    for _ in range(3):
        sched.step()

    def explode(finished):
        raise RuntimeError("injected")

    sched._decode_and_harvest = explode
    with pytest.raises(RuntimeError, match="injected"):
        sched.step()
    pool, dpool = sched.flight.crash["pool"], sched.flight.crash["draft_pool"]
    assert pool["paged"] and not dpool["paged"]
    assert dpool["free_slots"] == sched.draft_kv._free == sched.kv._free
    assert dpool["slot_len"] == [int(x) for x in sched.draft_kv.slot_len]
    sched.reset()
    assert sched.draft_kv.n_free == sched.draft_kv.n_slots
    assert {name: t.data_ptr() for name, t in sched.draft_kv.cache.items()} == ptrs


@pytest.mark.parametrize("fused", [True, False])
def test_self_draft_accepts_everything(runs, fused):
    """The target drafting for itself: every greedy proposal accepted, k+1
    tokens per ridden verify (8 decode tokens a request: two full rides),
    the non-speculative streams, and both pools drained."""
    sched, reqs = runs[f"self {fused}"]
    assert [r.tokens for r in reqs] == [r.tokens for r in runs["plain"][1]]
    st = sched.stats
    assert st.draft_proposed > 0 and st.acceptance_rate == 1.0
    assert st.tokens_per_verify_step == K + 1
    assert all(r.tokens_per_verify_step == K + 1 for r in reqs)
    _drained(sched)


def test_from_zoo_and_spec_config(setup):
    _, (tcfg, dcfg, target, _) = setup
    d = pspec.ModelDrafter.from_zoo(tcfg, 3, reduced=RED, device="cpu")
    assert d.kind == "model" and d.cfg == dcfg
    assert next(d.params.buffers()).device.type == "cpu"
    with pytest.raises(ValueError, match="no draft_arch pairing"):
        pspec.ModelDrafter.from_zoo(dcfg, device="cpu")
    with pytest.raises(ValueError, match="exceeds target vocab"):
        pspec.ModelDrafter.from_zoo(tcfg, reduced=dict(RED, vocab=256), device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        pspec.ModelDrafter(dataclasses.replace(dcfg, family="ssm"), target)
    # "model" resolves the full draft_arch pairing, whose vocab the reduced
    # target cannot score (as the reference refuses it)
    with pytest.raises(ValueError, match="exceeds target vocab"):
        serve.Scheduler(tcfg, target, spec=serve.SpecConfig(k=K, drafter="model"),
                        device="cpu", **SCHED)
    assert serve.ModelDrafter is pspec.ModelDrafter
