"""Port parity: speculative decoding with the n-gram drafter
(`repro_torch.serve.spec`, `transformer.verify_step` / `cache_rollback`,
`SlotKVCache.rollback`) against `repro.serve.spec` and `repro.models`.

The spec functions equal the reference's on random inputs; the verify
forward's logits and written cache rows agree within the model tests'
1e-4 on a paged pool (rows past a slot's allocation and an idle lane
included) and on a stripe (rows past its end dropped); the rollbacks
leave ``kpos`` and ``pos`` equal to the reference's.  Token streams of a
mixed greedy / "match"-sampled workload under `SpecConfig(k=3)`, fused
and unfused, are identical to the port's own non-speculative streams and
to the reference's speculative ones (reduced qwen2-0.5b in f32, prefix
sharing and async admission off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.models import zoo as jzoo
from repro.serve import spec as jspec
from repro_torch import serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import paging, zoo
from repro_torch.serve import prng
from repro_torch.serve import spec as pspec

TOL = 1e-4
MAX_SEQ = 64
SCHED = dict(max_slots=2, max_seq=MAX_SEQ, page=16, decode_chunk=4)
OUTS = ("emits", "cnt", "judged", "tok", "active", "rem", "gens")

# the reference's acceptance under jit: one compile per mode instead of
# many eager dispatches keeps the random-input cases cheap
j_acceptance = jax.jit(jspec.acceptance, static_argnames=("stochastic", "any_reject"))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the spec functions on random inputs
# ---------------------------------------------------------------------------


def _acceptance_inputs(mode, seed):
    rng = np.random.default_rng(seed)
    b, s, v = 12, 4, 64
    logits = (rng.normal(size=(b, s, v)) * 2).astype(np.float32)
    g = logits.argmax(-1)
    # most drafts follow the argmax chain, so runs of every length occur
    drafts = np.where(rng.random((b, s - 1)) < 0.7, g[:, : s - 1],
                      rng.integers(0, v, (b, s - 1))).astype(np.int32)
    sampled = mode != "greedy"
    return dict(
        logits=logits, drafts=drafts, tok=rng.integers(0, v, (b, 1)).astype(np.int32),
        seeds=rng.integers(0, 2**31 - 1, b).astype(np.int32),
        gens=rng.integers(0, 40, b).astype(np.int32),
        temp=np.where(rng.random(b) < 0.75, 0.8, 0.0).astype(np.float32) if sampled
        else np.zeros(b, np.float32),
        topk=rng.choice([0, 16, 4], b).astype(np.int32),
        topp=rng.choice([0.0, 0.9], b).astype(np.float32),
        eos=rng.choice([-1, int(g[0, 1]), int(g[1, 0])], b).astype(np.int32),
        rem=rng.integers(0, 6, b).astype(np.int32), active=rng.random(b) < 0.85,
        k_eff=rng.choice([0, 1, 2, 3], b).astype(np.int32),
        match=np.full(b, mode != "reject"))


@pytest.mark.parametrize("mode", ["greedy", "match", "reject"])
@pytest.mark.parametrize("seed", [0, 1])
def test_acceptance_matches(mode, seed):
    x = _acceptance_inputs(mode, seed)
    flags = dict(stochastic=mode != "greedy", any_reject=mode == "reject")
    kw = {k: x[k] for k in x if k not in ("logits", "drafts", "tok")}
    want = j_acceptance(jnp.asarray(x["logits"]), jnp.asarray(x["drafts"]),
                            jnp.asarray(x["tok"]), base_key=jax.random.PRNGKey(3),
                            **{k: jnp.asarray(v) for k, v in kw.items()}, **flags)
    got = pspec.acceptance(torch.from_numpy(x["logits"]), torch.from_numpy(x["drafts"]),
                           torch.from_numpy(x["tok"]), base_key=prng.PRNGKey(3),
                           **{k: torch.from_numpy(v) for k, v in kw.items()}, **flags)
    for name, w, g in zip(OUTS, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    emits, cnt = got[0].numpy(), got[1].numpy()
    assert (cnt[~x["active"]] == 0).all() and (emits[~x["active"]] == -1).all()
    if mode == "reject":
        # a rejected draft is never re-emitted at its own position: where a
        # reject lane emitted a correction at i < k_eff, it differs from
        # draft i (the residual draw excludes it)
        n_acc = np.cumprod(emits[:, :3] == x["drafts"], axis=1).sum(axis=1)
        for b in np.flatnonzero(x["active"] & (x["temp"] > 0)):
            i = n_acc[b]
            if i < min(cnt[b], x["k_eff"][b] + 1) and i < x["k_eff"][b]:
                assert emits[b, i] != x["drafts"][b, i]


def test_position_keys_are_the_sequential_keys():
    seeds = torch.tensor([3, 2**31 + 4], dtype=torch.int64)
    gens = torch.tensor([0, 17], dtype=torch.int32)
    keys = pspec.position_keys(prng.PRNGKey(9), seeds, gens, 4)
    want = jspec.position_keys(jax.random.PRNGKey(9), jnp.asarray(seeds.numpy().astype(
        np.uint32)), jnp.asarray(gens.numpy()), 4)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_propose_matches(n):
    rng = np.random.default_rng(n)
    hist = rng.integers(0, 4, (8, 40)).astype(np.int32)      # small alphabet: many hits
    hlen = rng.integers(1, 40, 8).astype(np.int32)
    tok = hist[np.arange(8), hlen - 1][:, None]
    want = jspec.ngram_propose(jnp.asarray(hist), jnp.asarray(hlen), jnp.asarray(tok), 3, n=n)
    got = pspec.ngram_propose(torch.from_numpy(hist), torch.from_numpy(hlen),
                              torch.from_numpy(tok), 3, n=n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_append_and_seed_history_match():
    """append_history equals the reference wherever the reference's scatter
    is defined: pads past the buffer clamp onto its last column there and
    rewrite what it holds.  Where a live token lands in that last column
    too, the reference's write order decides between the token and the
    pad's stale copy; the port writes live rows only, so the token stays
    (the scheduler never reads it: the request has reached max_seq)."""
    rng = np.random.default_rng(4)
    hist = rng.integers(0, 9, (6, 20)).astype(np.int32)
    hlen = np.array([0, 3, 16, 18, 12, 10], np.int32)
    emits = rng.integers(-1, 9, (6, 4)).astype(np.int32)
    cnt = np.array([4, 0, 4, 1, 1, 2], np.int32)
    want = jspec.append_history(jnp.asarray(hist), jnp.asarray(hlen), jnp.asarray(emits),
                                jnp.asarray(cnt))
    got = pspec.append_history(torch.from_numpy(hist), torch.from_numpy(hlen),
                               torch.from_numpy(emits), torch.from_numpy(cnt))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    full, _ = pspec.append_history(torch.from_numpy(hist), torch.full((6,), 19),
                                   torch.from_numpy(emits), torch.ones(6, dtype=torch.int32))
    np.testing.assert_array_equal(full[:, 19].numpy(), emits[:, 0])
    for prompt, max_seq in ((np.arange(5, dtype=np.int32), 16), (np.arange(30), 16)):
        for w, g in zip(jspec.seed_history(prompt, 77, max_seq),
                        pspec.seed_history(prompt, 77, max_seq)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# the verify forward and the rollbacks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = jload_arch("qwen2_0_5b").reduced()
    cfg = load_arch("qwen2_0_5b").reduced()
    packed = jax.jit(jzoo.pack_params, static_argnums=0)(
        jcfg, jax.jit(jzoo.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, packed), "cpu")
    return jcfg, cfg, packed, model


j_prefill = jax.jit(jzoo.prefill, static_argnums=1)
j_verify = jax.jit(jzoo.verify_step, static_argnums=1)
j_insert = jax.jit(jzoo.paged_insert, static_argnums=(0, 3, 4))
j_rollback = jax.jit(jzoo.cache_rollback, static_argnums=(0, 5))


def _prefilled(jcfg, cfg, packed, model, toks, n_rows):
    jc = jzoo.make_cache(jcfg, toks.shape[0], MAX_SEQ)
    _, jc = j_prefill(packed, jcfg, jnp.asarray(toks), jc, n_rows=jnp.asarray(n_rows))
    tc = zoo.make_cache(cfg, toks.shape[0], MAX_SEQ, device="cpu")
    zoo.prefill(model, cfg, torch.from_numpy(toks), tc, n_rows=torch.from_numpy(n_rows))
    return jc, tc


def _pools_agree(jpool, tpool, skip_reserved):
    lo = paging.N_RESERVED if skip_reserved else 0
    for name in ("k", "v"):
        _close(np.asarray(jpool[name])[:, lo:], tpool[name].numpy()[:, lo:])
    for name in ("kpos", "pos"):
        want, got = np.asarray(jpool[name]), tpool[name].numpy()
        if name == "kpos":
            want, got = want[:, lo:], got[:, lo:]
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def paged_verify(setup):
    """Two prompts scattered into a paged pool (shuffled pages; slot 0's
    allocation ends inside the verify's rows, slot 1 idle), then one
    4-row verify on both sides."""
    jcfg, cfg, packed, model = setup
    rng = np.random.default_rng(5)
    n_rows = np.array([9, 14], np.int32)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jst, tst = _prefilled(jcfg, cfg, packed, model, toks, n_rows)
    page, n_slots, n_pages = 8, 3, paging.N_RESERVED + 12
    n_bt = MAX_SEQ // page
    jpool = jzoo.make_cache(jcfg, n_slots, MAX_SEQ, page=page, n_pages=n_pages)
    tpool = zoo.make_cache(cfg, n_slots, MAX_SEQ, page=page, n_pages=n_pages, device="cpu")
    free = list(rng.permutation(np.arange(paging.N_RESERVED, n_pages)))
    for row, slot, n_alloc in ((0, 2, 3), (1, 0, 2)):
        pages = [int(free.pop()) for _ in range(n_alloc)]
        ids = np.full((n_bt,), paging.SCRATCH_PAGE, np.int32)
        bt_row = np.full((n_bt,), paging.SENTINEL_PAGE, np.int32)
        ids[:n_alloc] = bt_row[:n_alloc] = pages
        jpool = j_insert(jcfg, jpool, jst, slot, row, jnp.asarray(ids), jnp.asarray(bt_row),
                         np.int32(n_alloc))
        zoo.paged_insert(cfg, tpool, tst, slot, row, torch.from_numpy(ids),
                         torch.from_numpy(bt_row), n_alloc)
    tokens = rng.integers(0, cfg.vocab, (n_slots, 4)).astype(np.int32)
    pos0 = np.asarray(jzoo.cache_position(jcfg, jpool))
    jlog, jpool, undo = j_verify(packed, jcfg, jnp.asarray(tokens), jpool)
    tpos0 = zoo.cache_position(cfg, tpool)
    tlog, tundo = zoo.verify_step(model, cfg, torch.from_numpy(tokens), tpool)
    return pos0, (jlog, jpool, undo), (tpos0, tlog, tundo, tpool)


def test_paged_verify_logits_and_rows_match(paged_verify):
    pos0, (jlog, jpool, _), (tpos0, tlog, tundo, tpool) = paged_verify
    np.testing.assert_array_equal(tpos0.numpy(), pos0)
    assert tlog.shape == jlog.shape and tundo is None
    _close(jlog, tlog)                      # the idle lane's rows included
    # scratch (page 0) holds the out-of-allocation and idle-lane rows, in
    # an order neither side defines; every other page must agree
    _pools_agree(jpool, tpool, skip_reserved=True)
    np.testing.assert_array_equal(tpool["pos"].numpy()[0], pos0 + 4)


def test_paged_rollback_matches(setup, paged_verify):
    jcfg, cfg, _, _ = setup
    pos0, (_, jpool, undo), (_, _, _, tpool) = paged_verify
    keep = np.array([1, 0, 3], np.int32)
    jout = j_rollback(jcfg, jpool, undo, jnp.asarray(pos0), jnp.asarray(keep), 4)
    tout = zoo.cache_rollback(cfg, tpool, None, torch.tensor(pos0),
                              torch.from_numpy(keep), 4)
    assert tout is tpool                    # in place
    _pools_agree(jout, tpool, skip_reserved=True)
    np.testing.assert_array_equal(tpool["pos"].numpy()[0], pos0 + keep)


def test_stripe_verify_and_rollback_match(setup):
    """A stripe cache filled to 62 of its 64 rows: the verify's last two
    rows fall past the end and are dropped by both; rollback then sweeps
    the kept-past-keep rows and rewinds pos."""
    jcfg, cfg, packed, model = setup
    rng = np.random.default_rng(6)
    n_rows = np.array([62, 30], np.int32)
    toks = rng.integers(0, cfg.vocab, (2, MAX_SEQ)).astype(np.int32)
    jc, tc = _prefilled(jcfg, cfg, packed, model, toks, n_rows)
    tokens = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    jlog, jc, undo = j_verify(packed, jcfg, jnp.asarray(tokens), jc)
    tlog, _ = zoo.verify_step(model, cfg, torch.from_numpy(tokens), tc)
    _close(jlog, tlog)
    _pools_agree(jc, tc, skip_reserved=False)
    keep = np.array([2, 1], np.int32)
    jc = j_rollback(jcfg, jc, undo, jnp.asarray(n_rows), jnp.asarray(keep), 4)
    zoo.cache_rollback(cfg, tc, None, torch.from_numpy(n_rows), torch.from_numpy(keep), 4)
    _pools_agree(jc, tc, skip_reserved=False)


# ---------------------------------------------------------------------------
# the speculative scheduler
# ---------------------------------------------------------------------------


def _workload(mod, vocab):
    """Greedy requests and "match"-sampled ones (temperature, top-k, top-p,
    an explicit seed) over two length buckets, more requests than slots;
    the repeated motif gives the n-gram drafter hits to accept."""
    rng = np.random.default_rng(13)
    motif = rng.integers(0, vocab, (3,)).astype(np.int32)
    reqs = []
    for i in range(5):
        p = mod.SamplingParams(max_new_tokens=12 if i % 2 == 0 else 7)
        if i in (1, 3):
            p.temperature, p.top_k, p.top_p, p.seed = 0.8, 16, 0.9, 100 + i
        tail = rng.integers(0, vocab, (1 + i,)).astype(np.int32)
        prompt = np.concatenate([motif, tail, motif]) if i != 2 else tail
        reqs.append(mod.Request(rid=i, prompt=prompt, params=p, arrival=i))
    return reqs


@pytest.fixture(scope="module")
def reference_spec_streams(setup):
    jcfg, cfg, packed, _ = setup
    sched = jserve.Scheduler(jcfg, packed, prefix_share=False, async_admission=False,
                             spec=jserve.SpecConfig(k=3), **SCHED)
    reqs = _workload(jserve, cfg.vocab)
    sched.run(reqs)
    return [r.tokens for r in reqs], sched.stats


def _port_run(cfg, model, spec, **kw):
    sched = serve.Scheduler(cfg, model, spec=spec, async_admission=False, device="cpu",
                            **dict(SCHED, **kw))
    reqs = _workload(serve, cfg.vocab)
    sched.run(reqs)
    return sched, reqs


@pytest.mark.parametrize("mode", ["nonspec", "fused", "unfused"])
def test_spec_streams_identical(setup, reference_spec_streams, mode):
    _, cfg, _, model = setup
    want, jstats = reference_spec_streams
    spec = None if mode == "nonspec" else serve.SpecConfig(k=3, fused=mode == "fused")
    sched, reqs = _port_run(cfg, model, spec)
    assert [r.tokens for r in reqs] == want
    st = sched.stats
    if spec is None:
        assert st.verify_steps == 0 and sched.kv.rollback_sweeps == 0
        return
    cycles = st.verify_steps
    assert cycles == st.decode_steps and sched.kv.rollback_sweeps == cycles
    assert st.draft_accepted > 0 and sum(r.spec_verify_steps for r in reqs) > 0
    if spec.fused:
        # same cycle count per step as the reference's fused scan: the
        # speculative statistics then match the reference's one for one
        for name in ("verify_steps", "lane_verify_steps", "draft_proposed",
                     "draft_accepted", "decode_tokens"):
            assert getattr(st, name) == getattr(jstats, name), name
        assert st.acceptance_rate == jstats.acceptance_rate
    assert st.tokens_per_verify_step > 1.0


@pytest.mark.parametrize("fused", [True, False])
def test_spec_pool_conserves_pages(setup, reference_spec_streams, fused):
    _, cfg, _, model = setup
    sched = serve.Scheduler(cfg, model, spec=serve.SpecConfig(k=3, fused=fused),
                            async_admission=False, device="cpu", **SCHED)
    kv = sched.kv
    pending = _workload(serve, cfg.vocab)
    reqs, t = list(pending), 0
    while pending or sched.n_pending:
        while pending and pending[0].arrival <= t:
            sched.submit(pending.pop(0))
        sched.step()
        t += 1
        assert kv.n_free_pages + kv.n_referenced_pages == kv.n_alloc_pages
        for slot in sched._running:
            assert kv.slot_len[slot] <= kv.slot_capacity(slot)
            # exactly slot_len live rows: the rollback swept every rejected one
            pages = kv.slot_pages(slot)
            live = int((kv.cache["kpos"][0, pages] < paging.KPOS_SENTINEL).sum())
            assert live == kv.slot_len[slot]
    assert kv.n_free_pages == kv.n_alloc_pages
    assert bool((kv.cache["kpos"][:, paging.N_RESERVED:] == paging.KPOS_SENTINEL).all())
    assert [r.tokens for r in reqs] == reference_spec_streams[0]


def test_spec_per_request_opt_out_and_eos(setup, reference_spec_streams):
    """spec_k=0 rides the verify batch one token a step and still emits the
    non-speculative stream; an EOS inside an accepted run truncates the
    emit exactly where non-speculative decode stops."""
    _, cfg, _, model = setup
    want = reference_spec_streams[0]
    sched = serve.Scheduler(cfg, model, spec=serve.SpecConfig(k=3), async_admission=False,
                            device="cpu", **SCHED)
    reqs = _workload(serve, cfg.vocab)
    reqs[0].params.spec_k = 0
    eos = want[4][5]
    reqs[4].params.eos_id = eos
    sched.run(reqs)
    assert [r.tokens for r in reqs[:4]] == want[:4]
    assert reqs[0].spec_proposed == 0 and reqs[0].spec_verify_steps > 0
    assert reqs[0].acceptance_rate == 0.0
    assert reqs[4].tokens == want[4][: want[4].index(eos) + 1]
    assert reqs[4].finish_reason == "eos"
    assert sched.kv.n_free_pages == sched.kv.n_alloc_pages


def test_spec_reject_mode_valid(setup):
    """"reject" rejection sampling: a different but valid stream — the
    right count of in-vocab tokens, with speculation riding."""
    _, cfg, _, model = setup
    prompt = np.random.default_rng(47).integers(0, cfg.vocab, (8,)).astype(np.int32)
    for fused in (True, False):
        sched = serve.Scheduler(cfg, model, spec=serve.SpecConfig(k=3, fused=fused),
                                device="cpu", **SCHED)
        req = serve.Request(rid=0, prompt=np.tile(prompt, 3), params=serve.SamplingParams(
            max_new_tokens=12, temperature=0.9, seed=7, spec_accept="reject"))
        sched.run([req])
        assert len(req.tokens) == 12 and all(0 <= t < cfg.vocab for t in req.tokens)
        assert req.spec_verify_steps > 0


def test_spec_config_checks_and_stripe_pool(setup, reference_spec_streams):
    _, cfg, _, model = setup
    for bad, match in ((serve.SpecConfig(k=0), "k must be"),
                       (serve.SpecConfig(k=3, cycles=0), "cycles"),
                       (serve.SpecConfig(drafter="model"), "Queue 1 item 8"),
                       (serve.SpecConfig(drafter=object()), "unknown drafter")):
        with pytest.raises(ValueError, match=match):
            serve.Scheduler(cfg, model, spec=bad, device="cpu", **SCHED)
    with pytest.raises(ValueError, match="Queue 1 item 8"):
        pspec.ModelDrafter(cfg, model)
    # the stripe pool takes the same verify/rollback path
    sched, reqs = _port_run(cfg, model, serve.SpecConfig(k=3), page=None)
    assert [r.tokens for r in reqs] == reference_spec_streams[0]
