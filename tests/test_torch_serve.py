"""Port parity: the serving runtime (`repro_torch.serve`) against
`repro.serve` on the same HiNM-packed weights.

Reduced qwen2-0.5b in f32, packed by the reference's `zoo.pack_params`
and carried across by `params_from_numpy`.  Greedy token streams must be
identical to the reference's synchronous scheduler (prefix sharing and
async admission off), under both admission policies and through
`ServeEngine`; the paged pool conserves its pages at every step.  Sampled
requests and speculative decoding have their own files
(`test_torch_sample.py`, `test_torch_spec.py`).
"""
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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHED = dict(max_slots=2, max_seq=64, page=16, decode_chunk=4)
# staggered arrivals, prompts across the 8 and 16 length buckets, more
# requests than slots so slots and pages are reused
LENS = (5, 16, 8, 13)


@pytest.fixture(scope="module")
def setup():
    jcfg = jload_arch("qwen2_0_5b").reduced()
    cfg = load_arch("qwen2_0_5b").reduced()
    packed = jax.jit(jzoo.pack_params, static_argnums=0)(
        jcfg, jax.jit(jzoo.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, packed), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in LENS]
    return jcfg, cfg, packed, model, prompts


def _requests(mod, prompts):
    return [mod.Request(rid=i, prompt=p, arrival=i,
                        params=mod.SamplingParams(max_new_tokens=6))
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def reference_streams(setup):
    """The reference scheduler's greedy streams, once per policy: one
    scheduler (one set of compiled steps), reset and switched to the static
    policy for the second run."""
    jcfg, _, packed, _, prompts = setup
    out = {}
    sched = jserve.Scheduler(jcfg, packed, prefix_share=False, async_admission=False,
                             **SCHED)
    for policy in ("continuous", "static"):
        sched.reset()
        sched.policy = policy
        reqs = _requests(jserve, prompts)
        sched.run(reqs)
        out[policy] = [r.tokens for r in reqs]
    return out


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_scheduler_streams_identical(setup, reference_streams, policy):
    _, cfg, _, model, prompts = setup
    sched = serve.Scheduler(cfg, model, policy=policy, prefix_share=False,
                            async_admission=False, device="cpu", **SCHED)
    reqs = _requests(serve, prompts)
    done = sched.run(reqs)
    assert sorted(r.rid for r in done) == list(range(len(LENS)))
    assert [r.tokens for r in reqs] == reference_streams[policy]
    assert all(r.n_generated == 6 and r.finish_reason == "length" for r in reqs)
    assert sched.stats.decode_tokens == 5 * len(LENS)


def test_serve_engine_identical(setup):
    jcfg, cfg, packed, model, prompts = setup
    batch = np.stack([p[:5] for p in prompts[:2]])
    kw = dict(max_seq=64, decode_chunk=4, page=16)
    want, _ = jserve.ServeEngine(jcfg, packed, prefix_share=False, **kw).generate(
        batch, max_new_tokens=5)
    got, stats = serve.ServeEngine(cfg, model, prefix_share=False, device="cpu",
                                   **kw).generate(
        batch, max_new_tokens=5)
    np.testing.assert_array_equal(got, want)
    assert stats.requests_finished == 2


def test_page_conservation_and_no_leaks(setup, reference_streams):
    _, cfg, _, model, prompts = setup
    sched = serve.Scheduler(cfg, model, prefix_share=False, async_admission=False,
                            device="cpu", **SCHED)
    kv = sched.kv
    pending = _requests(serve, prompts)
    reqs, t = list(pending), 0
    while pending or sched.n_pending:
        while pending and pending[0].arrival <= t:
            sched.submit(pending.pop(0))
        sched.step()
        t += 1
        assert kv.n_free_pages + kv.n_referenced_pages == kv.n_alloc_pages
        for slot, req in sched._running.items():
            assert kv.slot_len[slot] <= kv.slot_capacity(slot)
            assert len(kv.slot_pages(slot)) == kv.pages_needed(
                len(req.prompt) + req.params.max_new_tokens)
    assert kv.n_free_pages == kv.n_alloc_pages and kv.n_free == SCHED["max_slots"]
    # every page went back swept: no live kpos row, every table pristine
    assert bool((kv.cache["kpos"][:, 2:] == 2**30).all())
    assert bool((kv.cache["bt"] == 1).all()) and bool((kv.cache["alloc"] == 0).all())
    assert [r.tokens for r in reqs] == reference_streams["continuous"]


def test_stripe_pool_streams_identical(setup, reference_streams):
    _, cfg, _, model, prompts = setup
    sched = serve.Scheduler(cfg, model, prefix_share=False, async_admission=False,
                            device="cpu", **dict(SCHED, page=None))
    reqs = _requests(serve, prompts)
    sched.run(reqs)
    assert [r.tokens for r in reqs] == reference_streams["continuous"]


def test_sampled_requests_and_missing_gpu_raise(setup):
    """Sampled requests are served now; what still raises: an unknown
    acceptance rule, the model drafter (not ported, named in ROADMAP.md),
    and a CUDA entry point without a card."""
    _, cfg, _, model, prompts = setup
    sched = serve.Scheduler(cfg, model, device="cpu", **SCHED)
    sched.submit(serve.Request(rid=0, prompt=prompts[0],
                               params=serve.SamplingParams(temperature=0.7, top_k=4)))
    assert sched.n_pending == 1
    with pytest.raises(ValueError, match="spec_accept"):
        sched.submit(serve.Request(rid=1, prompt=prompts[0],
                                   params=serve.SamplingParams(spec_accept="maybe")))
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 8"):
        serve.Scheduler(cfg, model, device="cpu", spec=serve.SpecConfig(drafter="model"),
                        **SCHED)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.Scheduler(cfg, model, **SCHED)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.ServeEngine(cfg, model)
