"""Port parity: serving on a mesh (`Scheduler(mesh=)`, `SlotKVCache(mesh=)`,
`paging.shard_geometry`) against the reference's sharded serving cases
(`tests/serve_conformance.py`'s `_drive` modes) at the same `_CASES`.

One spawned gloo group of 4 ranks (`tests/torch_dist_ranks.py`) serves
every case on a data-only mesh of 4, as the reference's 4-device runs
do: conformance (paged, stripe, a page-tight pool) for the transformer,
hybrid and encdec families, speculation fused and unfused on both
layouts, prefix sharing with copy-on-write and chunked prefill, with
speculation on top, K2 on a page-sharded pool (which the reference
downgrades, and the port does not: its pool is whole on every rank) and
on the replicated pools of `KNOBS.paged_attn_sharded`, the pool's churn
against a host refcount model, and the xlstm stripe fallback.  Every stream must equal the reference's
unsharded tokens, computed here: batch-1 prefill and a greedy
`zoo.decode_step` loop (the harness's `greedy_isolated`, jitted), on the
port's seeded weights laid out as the reference's params tree (the
transformer packed by the port, its packed fields stacked as the
reference's).  The page ids an alloc / free script draws from the port's
sharded pool must equal those of the reference's `SlotKVCache(mesh=)`,
run in one spawned JAX process on 4 fake host devices.
"""
import multiprocessing
import threading
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve_conformance as sc
import torch_dist_ranks as R
from repro.configs.base import load_arch as jload_arch
from repro.models import zoo as jzoo
from repro_torch import tree as T
from repro_torch.configs.base import load_arch
from repro_torch.models import zoo
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ("transformer", "hybrid", "encdec")
WORLD = 4


def _models():
    """Per family: (reference cfg, reference params, port model) from the
    port's seeded init; the transformer case packed."""
    out = {}
    for fam, c in sc._CASES.items():
        cfg = load_arch(c["arch"]).reduced(**c["reduced"])
        jcfg = jload_arch(c["arch"]).reduced(**c["reduced"])
        model = zoo.init(cfg, torch.Generator().manual_seed(c["seed"]), device="cpu")
        tree = T.map(lambda t: jnp.asarray(t.numpy()), zoo.params_of(cfg, model))
        if c.get("packed"):
            tree = R.reference_packed_tree(cfg, zoo.pack_params(cfg, model), tree)
        out[fam] = (jcfg, tree, model)
    return out


def _workload(fam, jcfg, share=False):
    fn = sc._share_workload if share else sc._workload
    with unittest.mock.patch.object(sc, "_model", lambda family: (jcfg, None)):
        return fn.__wrapped__(fam)


def _isolated(jcfg, params, prompts, embeds, n, cache_kw):
    """The reference's unsharded tokens: per request a batch-1 prefill and
    a greedy decode loop (`serve_conformance.greedy_isolated`), jitted."""
    def pre(params, tokens, emb):
        cache = jzoo.make_cache(jcfg, 1, sc.MAX_SEQ, **(cache_kw or {}))
        last, cache = jzoo.prefill(params, jcfg, tokens, cache, embeds=emb)
        return jzoo.logits_fn(params, jcfg, last)[:, :jcfg.vocab], cache

    pre = jax.jit(pre)
    dec = jax.jit(lambda params, tok, cache: jzoo.decode_step(params, jcfg, tok, cache))
    out = []
    for i, p in enumerate(prompts):
        emb = None if embeds is None else jnp.asarray(np.asarray(embeds[i])[None])
        lg, cache = pre(params, jnp.asarray(p[None]), emb)
        toks = [int(jnp.argmax(lg, -1)[0])]
        while len(toks) < n:
            lg, cache = dec(params, jnp.asarray([[toks[-1]]], jnp.int32), cache)
            toks.append(int(jnp.argmax(lg[:, :jcfg.vocab], -1)[0]))
        out.append(toks)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the reference's page lists and its unsharded
    tokens: the group and the JAX process start first, the reference's
    decodes run here on threads meanwhile."""
    models = _models()
    workloads = {fam: _workload(fam, models[fam][0]) for fam in sc._CASES}
    workloads["share"] = _workload("transformer", models["transformer"][0], share=True)
    cases = {fam: {k: v for k, v in c.items()} for fam, c in sc._CASES.items()}
    payload = dict(cases=cases, workloads=workloads,
                   models={fam: m for fam, (_, _, m) in models.items()})
    group = R.Group("sharded_serve_job", WORLD, tmp_path_factory.mktemp("sharded"), payload)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    jproc = ctx.Process(target=R.reference_pages, args=((0, 1), q))
    jproc.start()

    iso = {}

    def reference(name, fam, share=False):
        jcfg, params, _ = models[fam]
        c = sc._CASES[fam]
        prompts, embeds = workloads["share" if share else fam]
        iso[name] = _isolated(jcfg, params, prompts, embeds, c["max_new"], c.get("cache_kw"))

    threads = [threading.Thread(target=reference, args=(fam, fam)) for fam in sc._CASES]
    threads.append(threading.Thread(target=reference, args=("share", "transformer", True)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ok, ref_pages = q.get(timeout=240)
    jproc.join(timeout=30)
    assert ok, ref_pages
    ranks = group.results()
    return ranks, iso, ref_pages


def _r0(runs):
    return runs[0][0]


def test_ranks_agree(runs):
    """Every rank's host saw the same streams and made the same decisions."""
    ranks = runs[0]
    assert len(ranks) == WORLD
    for other in ranks[1:]:
        for key, val in ranks[0].items():
            if key == "churn":
                continue
            assert _tokens(other[key]) == _tokens(val), key


def _tokens(entry):
    """The token streams of one case's entry (facts differ by rank: the
    lanes and the local pages are the rank's own)."""
    if isinstance(entry, dict):
        return {k: _tokens(v) for k, v in entry.items() if "facts" not in str(k)}
    if isinstance(entry, tuple):
        return tuple(_tokens(v) for v in entry if not isinstance(v, dict))
    return entry


@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_sharded(runs, family):
    """paged == stripe == the reference's unsharded tokens on the mesh; the
    pool's specs split its page axis over 'data' and its page ids come
    from one free list a rank, while each rank stores the whole pool; the
    decode chunk ran data-parallel, one slot a rank."""
    r, iso = _r0(runs)[("conformance", family)], runs[1][family]
    f = r["facts"]
    assert r["paged"] == iso and r["stripe"] == iso
    assert f["paged"] and f["specs"] and r["stripe_facts"]["specs"]
    assert f["bucket"] == zoo.supports_bucketed_prefill(
        load_arch(sc._CASES[family]["arch"]))
    assert f["drained"]
    assert f["page_shards"] == WORLD and f["n_pages"] % WORLD == 0
    assert f["local_pages"] == f["n_pages"]
    assert f["pool_specs"][0][1] == "data" and f["pool_specs"][1][1] == "data"
    assert f["lanes"][1] - f["lanes"][0] == 1
    assert f["sharded"] and f["graphs"] == "eager" and f["eager"] > 0
    if family == "transformer":
        assert r["tight"] == iso and r["tight_facts"]["drained"]


@pytest.mark.parametrize("family", FAMILIES)
def test_spec_conformance_sharded(runs, family):
    """Speculation fused and unfused, both layouts, on the mesh."""
    iso = runs[1][family]
    for layout in ("paged", "stripe"):
        r = _r0(runs)[("spec", family, layout)]
        f, u = r["facts"], r["unfused_facts"]
        assert r["fused"] == iso and r["unfused"] == iso, layout
        assert f["verify_steps"] > 0 and f["decode_tokens"] > 0 and u["verify_steps"] > 0
        assert f["fused"] and f["spec_dispatches"] * f["spec_cycles"] == f["verify_steps"]
        assert u["draft"] == f["draft"]
        assert f["specs"]
        if layout == "paged":
            assert f["paged"] and f["drained"] and f["page_shards"] == WORLD


def test_share_conformance_sharded(runs):
    """Prefix sharing, copy-on-write and chunked prefill on the page-sharded
    pool: shared == unshared == the reference's; refcounts conserved; the
    pool pristine once the index is dropped."""
    r, iso = _r0(runs)["share"], runs[1]["share"]
    assert r["off"] == iso and r["on"] == iso and r["chunked"] == iso and r["spec"] == iso
    f = r["on_facts"]
    assert f["prefix"] and f["page_shards"] == WORLD
    assert f["prefix_hit_tokens"] > 0 and f["cow"] > 0 and f["conserved"]
    assert r["pristine"]
    assert r["chunked_facts"]["prefill_chunks"] > 0
    assert r["spec_facts"]["verify_steps"] > 0 and r["spec_facts"]["prefix_hit_tokens"] > 0


def test_spec_share_conformance_sharded(runs):
    """Speculation x chunked prefill x prefix sharing on the mesh: fused,
    unfused and synchronous admission give the reference's tokens, and
    sharing changes no draft's verdict."""
    r, iso = _r0(runs)["specshare"], runs[1]["share"]
    assert r["off"] == iso and r["on"] == iso
    assert r["on_facts"]["prefix_hit_tokens"] > 0
    assert r["on_facts"]["draft"] == r["off_facts"]["draft"]
    assert r["on_facts"]["draft"][1] > 0
    for name, (toks, f) in r["runs"].items():
        assert toks == iso, name
        assert f["prefill_chunks"] > 0 and f["verify_steps"] > 0, name
        assert f["draft"] == r["off_facts"]["draft"], name


def test_kernel_sharded_downgrade(runs):
    """The reference's downgrade case: on a pool whose specs split the
    page axis, the reference defers K2 to its gather path.  The port's
    pool is whole on every rank, so K2's dispatch is what it is off the
    mesh: no defer, no counter, the backend as requested (its plain
    version on the CPU); tokens unchanged, spec too."""
    r, iso = _r0(runs)[("kernel", "downgrade")], runs[1]["transformer"]
    assert r["tokens"] == iso and r["spec"] == iso
    f = r["facts"]
    assert f["page_shards"] == WORLD and f["pool_specs"][0][1] == "data"
    assert f["paged_attn"] == "auto" and f["defer"] is None and f["deferred"] == 0
    assert r["spec_facts"]["verify_steps"] > 0
    assert r["spec_facts"]["paged_attn"] == "auto" and r["spec_facts"]["defer"] is None


def test_kernel_sharded_replicated(runs):
    """`KNOBS.paged_attn_sharded` replicates the pools' specs: K2's dispatch
    stays engaged under the mesh (its plain version on the CPU), slot
    leaves' specs stay split, and the data-parallel writes merge into
    every copy."""
    r, iso = _r0(runs)[("kernel", "replicated")], runs[1]["transformer"]
    assert r["tokens"] == iso and r["spec"] == iso
    f = r["facts"]
    assert f["paged_attn"] == "auto" and f["defer"] is None
    assert f["deferred"] == 0
    assert f["pool_specs"][0][1] is None and f["pool_specs"][1][1] == "data"
    assert f["local_pages"] == f["n_pages"]


def test_churn_sharded(runs):
    """Admit / map / copy-on-write / rollback / release churn on the pool
    of 4 page shards, held to a host refcount model every step; device
    rows exact, the pool drained and swept (seeds 0, 1, 2, every rank)."""
    for rank in runs[0]:
        for seed, c in rank["churn"].items():
            assert c["rows_ok"] and c["refs_zero"] and c["drained"] and c["swept"], seed
            assert c["local_pages"] == 12


def test_xlstm_stripe_fallback_sharded(runs):
    """A pure-recurrent family falls back to stripes under the mesh too,
    its state tree resolved by `cache_specs` (slots over dp)."""
    r = _r0(runs)["xlstm"]
    assert r["tokens"] == runs[1]["ssm"]
    assert not r["facts"]["paged"] and r["facts"]["specs"]


def test_page_ids_equal_reference(runs):
    """Fullest-shard-first allocation hands out the reference's page ids:
    the same alloc / free script on the reference's 4-device
    `SlotKVCache(mesh=)` and the port's 4-rank one (16 pages, 4 a
    shard)."""
    ref = runs[2]
    for seed, pages in _r0(runs)["pages"].items():
        ref_pages, n_pages, sharded, n_lists = ref[seed]
        assert n_pages == 16 and sharded and n_lists == WORLD
        assert len(pages) > 5
        assert pages == [(s, list(p)) for s, p in ref_pages], seed
