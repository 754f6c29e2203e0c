"""Port parity: double-buffered admission and the scheduler's fixed
storage (`repro_torch.serve.Scheduler`, `async_admission`).

While a decode chunk is in flight the scheduler prepares the next
admission group (its prefill dispatched, no sync) and commits it at the
next step's start.  Token streams of a mixed greedy / "match"-sampled
workload with async admission on, plain and under `SpecConfig(k=3)` fused
and unfused, must equal the reference scheduler's with
`async_admission=True` (reduced qwen2-0.5b in f32, prefix sharing off) and
the port's own synchronous streams, with the overlap path engaged.

The captured CUDA graphs of the decode chunk, the spec cycles and the
prefills hold raw addresses, so the per-slot state, the KV pool and the
block tables must keep their storage across runs, `reset()` and
`ServeEngine` reuse: checked here on the CPU through `data_ptr`.
"""
import jax
import numpy as np
import pytest

from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.models import zoo as jzoo
from repro_torch import serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import paging
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHED = dict(max_slots=2, max_seq=64, page=16, decode_chunk=4)
STATE = ("_tok", "_active", "_rem", "_temp", "_topk", "_topp", "_eos", "_seeds", "_gens",
         "_keff", "_match", "_hist", "_hlen", "_key", "_emits")


@pytest.fixture(scope="module")
def setup():
    jcfg = jload_arch("qwen2_0_5b").reduced()
    cfg = load_arch("qwen2_0_5b").reduced()
    packed = jax.jit(jzoo.pack_params, static_argnums=0)(
        jcfg, jax.jit(jzoo.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, packed), "cpu")
    return jcfg, cfg, packed, model


def _workload(mod, vocab):
    """Six requests arriving one a step into two slots, over two length
    buckets: greedy ones and "match"-sampled ones (temperature, top-k,
    top-p, an explicit seed); a repeated motif gives the n-gram drafter
    hits to accept."""
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


@pytest.fixture(scope="module")
def reference_async(setup):
    """The reference scheduler with async admission, under SpecConfig(k=3):
    its greedy and "match" streams are the non-speculative ones too."""
    jcfg, cfg, packed, _ = setup
    sched = jserve.Scheduler(jcfg, packed, prefix_share=False, async_admission=True,
                             spec=jserve.SpecConfig(k=3), **SCHED)
    reqs = _workload(jserve, cfg.vocab)
    sched.run(reqs)
    overlaps = sched.telemetry.registry.counter("serve_overlap_admissions").value
    return [r.tokens for r in reqs], sched.stats, overlaps


def _overlaps(sched):
    """Admission groups prepared under a chunk in flight."""
    return sched.telemetry.registry.value("serve_overlap_admissions")


def _port_run(cfg, model, spec, async_admission):
    sched = serve.Scheduler(cfg, model, spec=spec, prefix_share=False,
                            async_admission=async_admission, device="cpu", **SCHED)
    reqs = _workload(serve, cfg.vocab)
    sched.run(reqs)
    return sched, [r.tokens for r in reqs]


@pytest.mark.parametrize("mode", ["plain", "fused", "unfused"])
def test_async_streams_match_reference_and_sync(setup, reference_async, mode):
    _, cfg, _, model = setup
    want, jstats, joverlaps = reference_async
    spec = None if mode == "plain" else serve.SpecConfig(k=3, fused=mode == "fused")
    sched, got = _port_run(cfg, model, spec, "auto")
    assert sched.async_admission
    assert got == want
    # the overlap path engaged: groups were prepared under a chunk in flight
    assert _overlaps(sched) > 0 and joverlaps > 0
    if mode == "fused":
        # the same admission schedule and cycle count as the reference's
        assert _overlaps(sched) == joverlaps
        for name in ("verify_steps", "lane_verify_steps", "draft_proposed",
                     "draft_accepted", "decode_tokens"):
            assert getattr(sched.stats, name) == getattr(jstats, name), name
    sync, got_sync = _port_run(cfg, model, spec, False)
    assert got_sync == got and _overlaps(sync) == 0
    assert sched.kv.n_free_pages == sched.kv.n_alloc_pages
    assert not sched._pending_admits and sched._pending_slots == sched._pending_pages == 0


def test_same_prefill_key_twice_in_one_window(setup):
    """Queue [A (bucket 8), B (bucket 16), C (bucket 8)] behind a decoding
    lane: one overlap window prepares three groups, A and C replaying the
    same prefill program (bucket 8, width 1).  Each must commit its own
    first token and rows: the streams equal the synchronous run's."""
    _, cfg, _, model = setup
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in (6, 5, 12, 7)]

    def requests():
        return [serve.Request(rid=i, prompt=p,
                              params=serve.SamplingParams(max_new_tokens=9 if i else 14))
                for i, p in enumerate(prompts)]

    out = {}
    for async_admission in (True, False):
        sched = serve.Scheduler(cfg, model, async_admission=async_admission, device="cpu",
                                **dict(SCHED, max_slots=4))
        reqs = requests()
        sched.submit(reqs[0])
        sched.step()                       # idle pool: admitted and decoding
        for r in reqs[1:]:
            sched.submit(r)
        sched.step()
        if async_admission:
            pending = sched._pending_admits
            assert [[r.rid for r in rec[0]] for rec in pending] == [[1], [2], [3]]
            assert sched._pending_slots == 3 and sched.n_pending == 4
            # A and C: one (bucket, width) key, each with a stripe of its own
            io = sched._prefill_io[(8, 1)]
            a, c = pending[0][2], pending[2][2]
            for name in io["cache"]:
                ptrs = {a[name].data_ptr(), c[name].data_ptr(), io["cache"][name].data_ptr()}
                assert len(ptrs) == 3
        while sched.n_pending:
            sched.step()
        out[async_admission] = [r.tokens for r in reqs]
        assert all(r.n_generated == r.params.max_new_tokens for r in reqs)
    assert out[True] == out[False]


def _ptrs(sched):
    state = {name: getattr(sched, name).data_ptr() for name in STATE}
    state.update({f"pool/{k}": v.data_ptr() for k, v in sched.kv.cache.items()})
    if sched.spec is not None:
        state.update({f"spec/{k}": v.data_ptr() for k, v in sched._spec_out.items()})
        state.update({f"verify/{k}": v.data_ptr() for k, v in sched._verify_out.items()})
    return state


def test_storage_stays_put_across_runs_resets_and_engine_reuse(setup):
    """Every state vector, `_key`, the static outputs, every pool leaf and
    the block tables keep their storage through a run, `reset()` and a
    second run; `reset()` restores pristine values in place.  The same
    holds through `ServeEngine.generate`, which reuses its scheduler."""
    _, cfg, _, model = setup
    sched = serve.Scheduler(cfg, model, spec=serve.SpecConfig(k=3, fused=False),
                            device="cpu", **SCHED)
    before = _ptrs(sched)
    first = _workload(serve, cfg.vocab)
    sched.run(first)
    assert _ptrs(sched) == before
    sched.reset(rng_seed=5)
    assert _ptrs(sched) == before
    pool = sched.kv.cache
    assert bool((pool["kpos"] == paging.KPOS_SENTINEL).all())
    assert bool((pool["bt"] == paging.SENTINEL_PAGE).all())
    assert not any(bool(pool[n].any()) for n in ("k", "v", "pos", "alloc"))
    assert not bool(sched._active.any()) and bool((sched._eos == -1).all())
    assert sched._key.tolist() == [0, 5]
    sched.reset()
    again = _workload(serve, cfg.vocab)
    sched.run(again)
    assert [r.tokens for r in again] == [r.tokens for r in first]
    assert _ptrs(sched) == before

    eng = serve.ServeEngine(cfg, model, max_seq=64, decode_chunk=4, page=16, device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    a, _ = eng.generate(prompts, max_new_tokens=5)
    inner = eng._sched
    ptrs = _ptrs(inner)
    b, _ = eng.generate(prompts, max_new_tokens=5)
    assert eng._sched is inner and _ptrs(inner) == ptrs
    np.testing.assert_array_equal(a, b)


def test_async_admission_needs_the_continuous_policy(setup):
    _, cfg, _, model = setup
    with pytest.raises(ValueError, match="continuous admission policy"):
        serve.Scheduler(cfg, model, policy="static", async_admission=True, device="cpu",
                        **SCHED)
    assert not serve.Scheduler(cfg, model, policy="static", device="cpu",
                               **SCHED).async_admission
