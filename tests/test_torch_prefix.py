"""Port parity: prefix sharing and chunked prefill (`repro_torch.serve.prefix`,
`SlotKVCache` refcounts and copy-on-write, `paging.map_attn` / `copy_page` /
`sweep_pages`, `transformer.extend_step`, the scheduler's extension
admission) against `repro.serve` and `repro.models`.

The prefix index gives the reference's matches, evictions and refcounts on
a fixed sequence of operations; the page helpers give its pools; the
extension forward its hidden states and pool rows (reduced qwen2-0.5b in
f32).  The share workload of `tests/serve_conformance.py` runs through the
port's and the reference's `Scheduler`, sync and async, with sharing on,
with chunked prefill and with speculation on top: token streams are equal
and the prefix statistics integer-equal, refcounts are conserved at every
step, and the pool drains to pristine once the index is dropped.  The
replay workload of `benchmarks/serve_bench.py` passes BENCH_serve_replay's
assertions on the port.  A port twin of `serve_conformance.run_churn`
holds the port's pool to an independent host refcount model.  K2's
row-tile plan is checked at the served shape for every s up to 256.
"""
import collections
import unittest.mock

import jax
import numpy as np
import pytest
import torch

import serve_conformance as sc
from benchmarks import serve_bench
from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.models import paging as jpaging
from repro.models import zoo as jzoo
from repro_torch import serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import paged_attn as pa
from repro_torch.models import paging, zoo

TOL = 1e-5


def _model(**reduced):
    """Reference-initialised, HiNM-packed reduced qwen2-0.5b (f32) on both
    sides: (reference cfg, port cfg, reference params, port model)."""
    jcfg = jload_arch("qwen2_0_5b").reduced(**reduced)
    cfg = load_arch("qwen2_0_5b").reduced(**reduced)
    packed = jax.jit(jzoo.pack_params, static_argnums=0)(
        jcfg, jax.jit(jzoo.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, packed, params_from_numpy(cfg, jax.tree.map(np.asarray, packed), "cpu")


# ---------------------------------------------------------------------------
# the prefix index over a stub pool
# ---------------------------------------------------------------------------


class _StubPool:
    """The three refcount hooks the index calls, on a host counter."""

    def __init__(self):
        self.ref = collections.Counter()
        self.next = 10

    def fresh(self, n):
        pages = list(range(self.next, self.next + n))
        self.next += n
        for p in pages:
            self.ref[p] = 1
        return pages

    def page_ref(self, p):
        return self.ref[p]

    def ref_pages(self, pages):
        for p in pages:
            assert self.ref[p] >= 1
            self.ref[p] += 1

    def deref_pages(self, pages):
        freed = 0
        for p in pages:
            self.ref[p] -= 1
            freed += self.ref[p] == 0
        return freed


def _index_script(mod):
    """A fixed sequence of register / match / release / evict(protect) /
    clear on `mod.PrefixIndex` over a stub pool: every outcome, in order."""
    page = 4
    idx, pool = mod.PrefixIndex(page), _StubPool()
    rng = np.random.default_rng(3)
    base = rng.integers(0, 50, 14)
    prompts = [np.concatenate([base[:n], rng.integers(50, 99, k)])
               for n, k in ((14, 3), (12, 5), (9, 6), (14, 1), (3, 9), (8, 8))]
    out, owned = [], []
    for p in prompts:
        m = idx.match(p, len(p) - 1)
        out.append(("match", m.page_ids, m.shared_rows, m.cow_src, m.cow_rows, m.total_rows))
        pages = m.page_ids + pool.fresh(-(-len(p) // page) - len(m.page_ids))
        for q in m.page_ids:
            pool.ref_pages([q])
        out.append(("register", idx.register(p, pages, pool), idx.n_pages))
        owned.append(pages)
    for pages in owned[:3]:                       # three slots release
        pool.deref_pages(pages)
    out.append(("refs", sorted(pool.ref.items())))
    m = idx.match(prompts[1], len(prompts[1]) - 1)
    protect = tuple(m.page_ids) + (() if m.cow_src is None else (m.cow_src,))
    out.append(("evict", idx.evict(pool, 3, protect=protect), idx.n_pages, idx.evictions))
    out.append(("evict", idx.evict(pool, 100), idx.n_pages, idx.evictions))
    out.append(("refs", sorted(pool.ref.items())))
    out.append(("match", idx.match(prompts[0], 13).page_ids))
    out.append(("clear", idx.clear(pool), idx.n_pages, sorted(pool.ref.items())))
    return out


def test_prefix_index_matches_reference():
    got, want = _index_script(serve), _index_script(jserve.prefix)
    assert got == want
    kinds = [o[0] for o in got]
    # the script reaches full-page hits, a CoW tail and real evictions
    assert any(o[0] == "match" and len(o) > 2 and o[1] for o in got)
    assert any(o[0] == "match" and len(o) > 2 and o[4] for o in got)
    assert any(o[0] == "evict" and o[1] > 0 for o in got) and "clear" in kinds


# ---------------------------------------------------------------------------
# the page helpers
# ---------------------------------------------------------------------------


def _pool(seed):
    """A random paged pool of 3 layers x 6 pages x page 4, 2 slots."""
    rng = np.random.default_rng(seed)
    return {"k": rng.normal(size=(3, 6, 4, 2, 8)).astype(np.float32),
            "v": rng.normal(size=(3, 6, 4, 2, 8)).astype(np.float32),
            "kpos": rng.integers(0, 40, (3, 6, 4)).astype(np.int32),
            "pos": rng.integers(0, 40, (3, 2)).astype(np.int32),
            "bt": rng.integers(0, 6, (3, 2, 5)).astype(np.int32),
            "alloc": rng.integers(0, 5, (3, 2)).astype(np.int32)}


def _equal(tpool, jpool):
    for name, leaf in jpool.items():
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(leaf), err_msg=name)


@pytest.mark.parametrize("op", ["map", "copy", "sweep"])
def test_page_helpers_match_reference(op):
    for seed in range(3):
        base = _pool(seed)
        tpool = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
        base = {k: jax.numpy.asarray(v) for k, v in base.items()}
        if op == "map":
            bt_row = np.asarray([4, 2, 5, 1, 1], np.int32)
            want = jpaging.map_attn(base, bt_row, 3, 9 + seed, 1)
            got = paging.map_attn(tpool, torch.from_numpy(bt_row), 3, 9 + seed, 1)
        elif op == "copy":
            want = jpaging.copy_page(base, 3 + seed, 2, 1 + seed)
            got = paging.copy_page(tpool, 3 + seed, 2, 1 + seed)
        else:
            ids = np.asarray([4, 2, paging.SCRATCH_PAGE], np.int32)
            want = jpaging.sweep_pages(base, ids)
            got = paging.sweep_pages(tpool, torch.from_numpy(ids))
        assert got is tpool                       # in place
        _equal(got, want)


# ---------------------------------------------------------------------------
# the extension forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    return _model()


def test_extend_step_and_rollback_match_reference(small):
    """Three slots prefilled (5, 12, 9 rows) into a paged pool of page 8;
    then one extension of 8 rows per slot, lanes 0 and 2 keeping 8 and 5
    rows, lane 1 (a co-resident decode lane) keeping none: the hidden
    states within 1e-5, then after `cache_rollback` the K/V rows within
    1e-5 and kpos, pos and the tables equal."""
    jcfg, cfg, packed, model = small
    lens, width, keep = (5, 12, 9), 8, np.asarray([8, 0, 5], np.int32)
    rng = np.random.default_rng(11)
    prompts = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, cfg.vocab, n)
    ext = rng.integers(0, cfg.vocab, (3, width)).astype(np.int32)
    n_rows = np.asarray(lens, np.int32)
    geom = dict(page=8, n_pages=14)
    jpool = jzoo.make_cache(jcfg, 3, 64, **geom)
    tpool = zoo.make_cache(cfg, 3, 64, device="cpu", **geom)
    _, jstripe = jzoo.prefill(packed, jcfg, jax.numpy.asarray(prompts),
                              jzoo.make_cache(jcfg, 3, 64), n_rows=jax.numpy.asarray(n_rows))
    tstripe = zoo.make_cache(cfg, 3, 64, device="cpu")
    zoo.prefill(model, cfg, torch.from_numpy(prompts), tstripe, n_rows=torch.from_numpy(n_rows))
    for slot in range(3):
        pages = np.asarray([2 + 4 * slot + j for j in range(4)], np.int32)
        ids = np.full((8,), paging.SCRATCH_PAGE, np.int32)
        bt_row = np.full((8,), paging.SENTINEL_PAGE, np.int32)
        ids[:4] = bt_row[:4] = pages
        jpool = jzoo.paged_insert(jcfg, jpool, jstripe, slot, slot, ids, bt_row, 4)
        zoo.paged_insert(cfg, tpool, tstripe, slot, slot, torch.from_numpy(ids),
                         torch.from_numpy(bt_row), 4)
    jpos0 = jzoo.cache_position(jcfg, jpool)
    jx, jpool, jundo = jzoo.extend_step(packed, jcfg, jax.numpy.asarray(ext), jpool)
    pos0 = zoo.cache_position(cfg, tpool)
    x, undo = zoo.extend_step(model, cfg, torch.from_numpy(ext), tpool)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=TOL, atol=TOL)
    jpool = jzoo.cache_rollback(jcfg, jpool, jundo, jpos0, jax.numpy.asarray(keep), width)
    zoo.cache_rollback(cfg, tpool, undo, pos0, torch.from_numpy(keep), width)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(), np.asarray(jpool[name]), rtol=TOL,
                                   atol=TOL, err_msg=name)
    for name in ("kpos", "pos", "bt", "alloc"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]),
                                      err_msg=name)
    assert tpool["pos"][0].tolist() == [n + k for n, k in zip(lens, keep)]


# ---------------------------------------------------------------------------
# K2's row-tile plan
# ---------------------------------------------------------------------------


def test_k2_row_tile_plan():
    """At chip_smoke's K2 shape (B 4, KV 2, G 7, hd 64, page 16, n_bt 16):
    s = 1 and s = 4 keep the plan they had (8 splits, every row in one
    block); every s up to 256 keeps the s = 1 splits, and its tiles cover
    the s * G rows, hold at most TILE_ROWS and fit a block's shared memory,
    in bf16 and f32."""
    for isz in (2, 4):
        n1 = pa.split_count(4, 2, 16, 7, 16, 64, isz)
        assert pa.plan(4, 2, 16, 7, 1, 16, 64, isz) == (n1, 7) == (8, 7)
        assert pa.plan(4, 2, 16, 7, 4, 16, 64, isz) == (8, 28)
        pages = -(-16 // n1)
        fit = max(r for r in range(1, pa.TILE_ROWS + 1)
                  if pa._smem_bytes(r, 64, 16, pages, isz) <= pa.SMEM_MAX)
        for s in range(1, 257):
            n, rows = pa.plan(4, 2, 16, 7, s, 16, 64, isz)
            gs = 7 * s
            assert n == n1 and 1 <= rows <= min(gs, fit)
            tiles = -(-gs // rows)
            assert (tiles - 1) * rows < gs <= tiles * rows
            # the fewest tiles that fit; one where all rows fit, as before
            assert tiles == -(-gs // fit)
        # extension widths run in tiles at this shape
        assert pa.plan(4, 2, 16, 7, 64, 16, 64, isz)[1] < 7 * 64


# ---------------------------------------------------------------------------
# the share workload through both schedulers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def share():
    """The reduced model of serve_conformance's transformer case (packed,
    not pruned) and its share workload: 5 prompts over one shared base of
    2.5 pages (page 16), arriving one a step."""
    c = sc._CASES["transformer"]
    jcfg, cfg, packed, model = _model(**c["reduced"])
    with unittest.mock.patch.object(sc, "_model", lambda family: (jcfg, None)):
        prompts, _ = sc._share_workload.__wrapped__("transformer")
    return jcfg, cfg, packed, model, prompts, c


# (prefill_chunk, spec) per config: sharing on; chunked prefill of one
# page; speculation over shared pages with chunking
SHARE_CONFIGS = {"share": (None, False), "chunked": (True, False), "spec": (True, True)}
SHARE_STATS = ("prefix_hit_tokens", "prefill_rows", "prefill_chunks", "tokens_generated",
               "decode_tokens", "requests_finished")


def _share_sched(mod, cfg, params, c, chunk, spec, async_admission, **kw):
    return mod.Scheduler(cfg, params, max_slots=4, max_seq=sc.MAX_SEQ, decode_chunk=4,
                         page=c["page"], n_pages="auto", prefix_share=True,
                         prefill_chunk=c["page"] if chunk else None,
                         spec=mod.SpecConfig(k=3) if spec else None,
                         async_admission=async_admission, **kw)


def _share_requests(mod, prompts, c):
    return [mod.Request(rid=i, prompt=p, arrival=i,
                        params=mod.SamplingParams(max_new_tokens=c["max_new"]))
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def reference_share(share):
    """The reference's runs of every config, sync and async: one scheduler
    per spec setting, its `prefill_chunk` and `async_admission` switched
    between runs (one set of compiled programs each)."""
    jcfg, _, packed, _, prompts, c = share
    out = {}
    for spec in (False, True):
        sched = _share_sched(jserve, jcfg, packed, c, False, spec, False)
        for name, (chunk, sp) in SHARE_CONFIGS.items():
            if sp != spec:
                continue
            for async_admission in (False, True):
                sched.reset()
                sched.prefill_chunk = c["page"] if chunk else None
                sched.async_admission = async_admission
                reqs = _share_requests(jserve, prompts, c)
                sched.run(reqs)
                st = sched.stats
                out[name, async_admission] = (
                    [r.tokens for r in reqs], {k: getattr(st, k) for k in SHARE_STATS},
                    sched.kv.cow_copies, [r.prefix_hit_tokens for r in reqs])
    return out


def _index_refs(index):
    """Page -> retention references the index holds (one per node)."""
    refs, stack = collections.Counter(), list(index._root.children.values())
    while stack:
        n = stack.pop()
        refs[n.page_id] += 1
        stack.extend(n.children.values())
    return refs


@pytest.mark.parametrize("async_admission", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("config", list(SHARE_CONFIGS))
def test_share_streams_and_stats_match_reference(share, reference_share, config,
                                                 async_admission):
    _, cfg, _, model, prompts, c = share
    chunk, spec = SHARE_CONFIGS[config]
    sched = _share_sched(serve, cfg, model, c, chunk, spec, async_admission, device="cpu")
    assert sched.prefix is not None and sched.async_admission == async_admission
    kv = sched.kv
    pending = _share_requests(serve, prompts, c)
    reqs, t = list(pending), 0
    while pending or sched.n_pending:
        while pending and pending[0].arrival <= t:
            sched.submit(pending.pop(0))
        sched.step()
        t += 1
        # every page's references: one per block table naming it, one per
        # index node; free exactly where there are none
        refs = _index_refs(sched.prefix)
        for slot in list(sched._running) + list(sched._prefilling):
            refs.update(kv.slot_pages(slot))
        for p in range(paging.N_RESERVED, kv.n_pages):
            assert kv.page_ref(p) == refs[p], (t, p)
        assert kv.n_free_pages + kv.n_referenced_pages == kv.n_alloc_pages
    want_tokens, want_stats, want_cow, want_hits = reference_share[config, async_admission]
    assert [r.tokens for r in reqs] == want_tokens
    assert {k: getattr(sched.stats, k) for k in SHARE_STATS} == want_stats
    assert kv.cow_copies == want_cow and [r.prefix_hit_tokens for r in reqs] == want_hits
    # the sharing machinery engaged: full-page hits, a copied tail, chunks
    assert sched.stats.prefix_hit_tokens > 0 and sched.stats.prefix_hit_rate > 0
    assert kv.cow_copies > 0
    if chunk:
        assert sched.stats.prefill_chunks > 0
    if spec:
        assert sched.stats.verify_steps > 0
    # pristine once the index is dropped
    sched.clear_prefix_cache()
    assert kv.n_free_pages == kv.n_alloc_pages and kv.n_referenced_pages == 0
    assert bool((kv.cache["kpos"][:, paging.N_RESERVED:] == paging.KPOS_SENTINEL).all())


def test_sharing_arguments_and_defaults(share):
    """"auto" turns sharing on for a paged pool under the continuous policy
    and off elsewhere; an explicit True where it cannot run, or chunked
    prefill without it, raises; the facade passes both through."""
    _, cfg, _, model, _, c = share
    kw = dict(max_slots=2, max_seq=64, page=16, device="cpu")
    assert serve.Scheduler(cfg, model, **kw).prefix is not None
    assert serve.Scheduler(cfg, model, policy="static", **kw).prefix is None
    assert serve.Scheduler(cfg, model, **dict(kw, page=None)).prefix is None
    for bad in (dict(policy="static", prefix_share=True), dict(page=None, prefix_share=True),
                dict(page=None, prefill_chunk=16)):
        with pytest.raises(ValueError, match="paged pool"):
            serve.Scheduler(cfg, model, **{**kw, **bad})
    with pytest.raises(ValueError, match="prefill_chunk must be"):
        serve.Scheduler(cfg, model, prefill_chunk=0, **kw)
    eng = serve.ServeEngine(cfg, model, max_seq=64, page=16, decode_chunk=4, prefill_chunk=16,
                            device="cpu")
    eng.generate(np.zeros((2, 20), np.int32), max_new_tokens=3)
    assert eng._sched.prefill_chunk == 16 and eng._sched.prefix is not None


# ---------------------------------------------------------------------------
# the replay workload of benchmarks/serve_bench.py
# ---------------------------------------------------------------------------


def test_replay_workload_passes_bench_assertions():
    """`serve_bench._replay_workload` at scale 1 (15 Poisson arrivals: 12
    short completions over one system prefix, 3 long unshared prompts)
    driven by `serve_bench._drive_replay` on the port, at the bench's pool
    (4 slots, max_seq 128, 20 pages of 16, chunk 16): the assertions
    `serve_bench.run_replay` makes of the reference hold."""
    jcfg, cfg, _, model = _model(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                                 vocab=256, head_dim=32, max_seq=128)
    slots, chunk = 4, serve_bench.PAGE

    def case(**kw):
        sched = serve.Scheduler(cfg, model, max_slots=slots, max_seq=128, decode_chunk=4,
                                page=serve_bench.PAGE, n_pages=20, device="cpu", **kw)
        reqs = [serve.Request(rid=r.rid, prompt=r.prompt, arrival=r.arrival,
                              params=serve.SamplingParams(max_new_tokens=r.params.max_new_tokens))
                for r in serve_bench._replay_workload(jcfg, 1.0)]
        return serve_bench._drive_replay(sched, reqs)

    nosh = case(prefix_share=False)
    share_row = case(prefix_share=True)
    chunked = case(prefix_share=True, prefill_chunk=chunk)
    assert share_row["prefix_hit_rate"] > 0 and share_row["cow_copies"] > 0
    assert share_row["live_page_steps"] < nosh["live_page_steps"]
    assert share_row["prefill_rows"] < nosh["prefill_rows"]
    assert chunked["prefill_chunks"] > 0
    assert chunked["max_prefill_rows_step"] <= chunk * slots
    assert chunked["max_prefill_rows_step"] < share_row["max_prefill_rows_step"]
    assert nosh["tokens"] == share_row["tokens"] == chunked["tokens"]


# ---------------------------------------------------------------------------
# the churn twin
# ---------------------------------------------------------------------------


def run_churn(seed, n_ops=40):
    """The port twin of `serve_conformance.run_churn`: random admit /
    map-with-copy-on-write / rollback / release churn on the port's paged
    `SlotKVCache` (4 slots, max_seq 64, page 8, 10 pages), drawn from
    `seed` exactly as the reference's harness draws, held at every step to
    an independent host refcount model; then every live slot's device rows
    are exactly its tracked rows, and the pool drains to pristine."""
    cfg = load_arch("qwen2_0_5b").reduced(**sc._CASES["transformer"]["reduced"])
    kv = serve.SlotKVCache(cfg, 4, sc.MAX_SEQ, page=8, n_pages=10, device="cpu")
    assert kv.paged and kv.n_pages == 12
    bytes0 = kv.pool_bytes()
    tpl = kv.template(1)
    ar = torch.arange(sc.MAX_SEQ, dtype=torch.int32)
    rng = np.random.default_rng(seed)
    # slot -> [rows, reserved rows, floor]: a rollback never rewinds below
    # `floor` (rows in pages another owner maps)
    live: dict[int, list[int]] = {}
    model_ref: dict[int, int] = {}
    refused = []                                  # tails longer than a page

    def check():
        for p in range(paging.N_RESERVED, kv.n_pages):
            assert kv.page_ref(p) == model_ref.get(p, 0), p
        n_ref = sum(1 for v in model_ref.values() if v > 0)
        assert kv.n_free_pages == kv.n_alloc_pages - n_ref
        assert kv.n_referenced_pages == n_ref
        assert kv.pool_bytes() == bytes0

    def rows_on_device(slot):
        kpos = kv.cache["kpos"][0]
        bt = kv.cache["bt"][0, slot]
        alloc = int(kv.cache["alloc"][0, slot])
        rows = [int(kpos[bt[p // kv.page], p % kv.page]) for p in range(alloc * kv.page)]
        return [i for i, r in enumerate(rows) if r != paging.KPOS_SENTINEL]

    for _ in range(n_ops):
        roll = rng.random()
        can_roll = [s for s in sorted(live) if live[s][0] - live[s][2] >= 1]
        donors = [s for s in sorted(live) if live[s][0] >= kv.page]
        if can_roll and roll < 0.25:
            slot = int(rng.choice(can_roll))
            rows_now, _, floor = live[slot]
            n_spec = int(rng.integers(1, min(rows_now - floor, 6) + 1))
            keep_n = int(rng.integers(0, n_spec + 1))
            pos0 = np.zeros((kv.n_slots,), np.int32)
            keep = np.zeros((kv.n_slots,), np.int32)
            for s, (r, _, _) in live.items():
                pos0[s] = r
            pos0[slot], keep[slot] = rows_now - n_spec, keep_n
            free_before = kv.n_free_pages
            kv.rollback(pos0, keep, n_spec)
            live[slot][0] = rows_now - n_spec + keep_n
            kv.slot_len[slot] = live[slot][0]
            assert kv.n_free_pages == free_before
            assert kv.slot_capacity(slot) == live[slot][1]
            assert int(kv.cache["pos"][0, slot]) == live[slot][0]
        elif donors and kv.n_free > 0 and 0.25 <= roll < 0.45:
            donor = int(rng.choice(donors))
            d_rows = live[donor][0]
            d_pages = kv.slot_pages(donor)
            n_share = int(rng.integers(1, d_rows // kv.page + 1))
            shared = d_pages[:n_share]
            shared_rows = n_share * kv.page
            cow_src, cow_rows = None, 0
            rem = d_rows - shared_rows
            if rem > 0 and rng.random() < 0.5:
                cow_src = d_pages[n_share]
                cow_rows = int(rng.integers(1, rem + 1))
            mapped = shared_rows + cow_rows
            reserve = min(sc.MAX_SEQ, mapped + int(rng.integers(1, 16)))
            n_fresh = kv.pages_needed(reserve) - n_share
            if n_fresh < 1 or n_fresh > kv.n_free_pages:
                check()
                continue
            if cow_rows > kv.page:
                # a tail longer than one page (the draw allows up to the
                # donor's remaining rows; `PrefixIndex.match` never gives
                # one): the reference's map_slot takes it and its slot then
                # claims rows no copy wrote (its run_churn fails so at seed
                # 38); the port refuses it before touching the pool
                with pytest.raises(ValueError, match="within one page"):
                    kv.map_slot(0, shared, shared_rows, reserve, cow_src=cow_src,
                                cow_rows=cow_rows)
                refused.append((shared, cow_src, cow_rows))
                check()
                continue
            slot = kv.acquire()
            pages = kv.map_slot(slot, shared, shared_rows, reserve, cow_src=cow_src,
                                cow_rows=cow_rows)
            assert pages[:n_share] == shared
            for p in pages:
                model_ref[p] = model_ref.get(p, 0) + 1
            live[donor][2] = max(live[donor][2], shared_rows)
            live[slot] = [mapped, reserve, mapped]
            assert kv.slot_len[slot] == mapped and kv.slot_capacity(slot) == reserve
        elif kv.n_free > 0 and (not live or roll < 0.65):
            rows = int(rng.integers(1, 33))
            reserve = min(sc.MAX_SEQ, rows + int(rng.integers(0, 16)))
            if not kv.can_admit(reserve):
                check()
                continue
            slot = kv.acquire()
            stripe = dict(tpl, kpos=torch.where(ar[None, None, :] < rows, ar[None, None, :],
                                                paging.KPOS_SENTINEL).expand_as(tpl["kpos"]),
                          pos=torch.full_like(tpl["pos"], rows))
            kv.insert(slot, stripe, rows, reserve=reserve)
            live[slot] = [rows, reserve, 0]
            for p in kv.slot_pages(slot):
                assert model_ref.get(p, 0) == 0
                model_ref[p] = 1
            assert kv.slot_len[slot] == rows and kv.slot_capacity(slot) == reserve
        elif live:
            slot = int(rng.choice(sorted(live)))
            pages = kv.slot_pages(slot)
            kv.release(slot)
            live.pop(slot)
            for p in pages:
                model_ref[p] -= 1
            assert kv.slot_len[slot] == 0 and kv.slot_capacity(slot) == 0
        check()

    for slot, (rows_now, _, _) in live.items():
        assert rows_on_device(slot) == list(range(rows_now)), \
            f"slot {slot}: device rows diverged after rollback/share churn"
    for slot in sorted(live):
        for p in kv.slot_pages(slot):
            model_ref[p] -= 1
        kv.release(slot)
    assert all(v == 0 for v in model_ref.values())
    assert kv.n_free_pages == kv.n_alloc_pages and kv.n_free == kv.n_slots
    assert (kv.slot_len == 0).all()
    assert bool((kv.cache["kpos"][:, paging.N_RESERVED:] == paging.KPOS_SENTINEL).all())
    assert bool((kv.cache["kpos"][:, paging.SENTINEL_PAGE] == paging.KPOS_SENTINEL).all())
    return refused


@pytest.mark.parametrize("seed", [0, 1, 7, 38, 101])
def test_churn_twin(seed):
    refused = run_churn(seed)
    if seed == 38:
        # the draw that breaks the reference: slot 0's pages [5, 9] shared,
        # an 11-row tail of its page 3 (page 8)
        assert refused == [([5, 9], 3, 11)]
