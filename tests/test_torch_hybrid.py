"""Port parity: the hybrid family (`repro_torch.models.rglru`,
`repro_torch.models.hybrid`, recurrentgemma-9b) against `repro.models.rglru`
and `repro.models.hybrid`, on the same numpy inputs, on the CPU.

- The RG-LRU block with and without a cache, and the model's eval
  forward, prefill and decode steps (logits and every cache leaf) agree
  within 2e-5 (f32: the scan's sum order and the reference's differ) at
  `reduced()` (6 layers, two full periods) and at `reduced(n_layers=5)`
  (a partial period of two layers after the full one).  The log-depth
  scan equals the step-by-step recurrence within 1e-5.
- `tests/test_models.py`'s ring test, on the port: with a cache of only
  the window (16 rows), a prefill of 20 tokens and a decode step give the
  full-history forward's logits within rtol/atol 3e-3.
- `compile_model_graph` gives the reference's three containers;
  `prune_model` on `tests/test_prune_model.py`'s hybrid config (5 layers,
  stacks of 2 / 2 / 1; MQA and d_ff = d_model here, `torch_hybrid_ref`)
  gives the reference's masks per stack (noperm, and gyro 2/2 scored with
  the reference's own cost helpers); the packed forward equals the
  masked one.
- The reference serving harness's hybrid case (`tests/serve_conformance.py`:
  window 16, 3 layers, page 8, prompts of 8 / 20 / 12 tokens, 6 new each;
  the 20-token prompt is rolled into the ring) through the port's
  `Scheduler`: paged and stripe streams equal the reference scheduler's
  and the port's isolated decoding; the paged run's flight record equals
  the reference's event for event (after dropping the backend names that
  differ by design); `SpecConfig(k=3)`, fused and unfused, paged and
  stripe, equals the reference's streams, and over 30 new tokens, with
  drafts accepted in part, the port's plain ones.
- `snapshot_attn_row` / `restore_attn_rows` / `select_state` equal the
  reference's on a paged and a stripe ring that wraps mid-verify, and a
  fully rejected verify restores the cache it started from.
- `bucket=True` and prefix sharing are refused with the reference's
  message; a released slot's state is pristine.

The harness case's weights are the reference's init at its seed; the
other configs' are the port's seeded init laid out as the reference's
params tree (`zoo.params_of`).  The reference's side runs in three spawned
processes beside the port's work (`tests/torch_hybrid_ref.py`).
"""
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_hybrid_ref as ref
from repro import serve as jserve
from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import load_arch as jload_arch
from repro.core.types import HiNMConfig as JHiNMConfig
from repro.models import zoo as jzoo
from repro.perm import compile_model_graph as jcompile_model_graph
from repro_torch import serve
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, load_arch
from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.core.types import HiNMConfig, PackedHiNM
from repro_torch.models import hybrid, paging, rglru, zoo
from repro_torch.perm import compile_model_graph
from repro_torch.serve import Scheduler, SpecConfig
from repro_torch.serve.kv import SlotKVCache
from repro_torch.train import pruning
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_train_ref import reference_search_costs

TOL = 2e-5
CASE = ref.CASE
MAX_SEQ = ref.sc.MAX_SEQ
# `reduced()` at its defaults (6 layers), and with a partial period
CONFIGS = {"reduced": {}, "partial": {"n_layers": 5}}
SCHED = ref.SCHED
# event fields whose values differ between the packages by design (see
# tests/test_torch_flightrec.py)
BY_DESIGN = {"config": ("paged_attn",), "dispatch": ("requested", "backend", "defer")}


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cfgs(name):
    return (jload_arch("recurrentgemma_9b").reduced(**CONFIGS[name]),
            load_arch("recurrentgemma_9b").reduced(**CONFIGS[name]))


def _inputs(cfg):
    """A block input (2, 5, D), a random RG-LRU state, the forward's and
    the prefill's tokens and two decode steps' tokens."""
    rng = np.random.default_rng(47)
    d, r = cfg.d_model, cfg.rglru_dim

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(x=normal(2, 5, d), state=dict(h=normal(2, r), conv=normal(2, 3, r)),
                tokens=rng.integers(0, cfg.vocab, (2, 7)).astype(np.int32),
                decode=rng.integers(0, cfg.vocab, (2, 2, 1)).astype(np.int32))


def _prune_cfgs():
    return (JArchConfig(**ref.PRUNE, dtype=jnp.float32, hinm=JHiNMConfig(**ref.HINM)),
            ArchConfig(**ref.PRUNE, dtype=torch.float32, hinm=HiNMConfig(**ref.HINM)))


def _numpy_init(cfg, seed):
    """The port's seeded init as the reference's params tree, numpy."""
    model = zoo.init(cfg, torch.Generator().manual_seed(seed), "cpu")
    return jax.tree.map(lambda t: t.numpy(), zoo.params_of(cfg, model))


# a longer run of the harness's prompts, in which the n-gram drafter's
# proposals are accepted in part (the harness's 6 tokens accept none)
LONG_NEW = 30
# the port's scheduler runs on the harness's case: (max_new, Scheduler
# arguments) by name
SERVE_RUNS = {
    "paged": (CASE["max_new"], {}),
    "stripe": (CASE["max_new"], dict(page=None, bucket=False)),
    **{f"spec {'fused' if f else 'unfused'} {layout}": (CASE["max_new"], dict(
        spec=SpecConfig(k=3, fused=f), **({} if layout == "paged" else dict(page=None,
                                                                            bucket=False))))
       for f in (True, False) for layout in ("paged", "stripe")},
    "long": (LONG_NEW, {}),
    **{f"long spec {'fused' if f else 'unfused'}": (LONG_NEW, dict(spec=SpecConfig(
        k=3, fused=f))) for f in (True, False)},
}


# Scheduler arguments the family refuses
REFUSED = {"bucket": dict(bucket=True), "prefix sharing": dict(prefix_share=True)}


def _serve(cfg, model, prompts, max_new, **kw):
    sched = Scheduler(cfg, model, **{**SCHED, **kw}, device="cpu")
    reqs = ref.requests(serve, prompts, max_new)
    sched.run(reqs)
    return [r.tokens for r in reqs], sched


@pytest.fixture(scope="module")
def setup():
    """Each config's weights and reference runs, the harness's recorded
    scheduler run with the reference's rollback cases, and the reference's
    prune (gyro and noperm), in three spawned processes
    (`torch_hybrid_ref`); beside them the port's prunes, model builds and
    scheduler runs (`SERVE_RUNS`)."""
    cfgs = {name: _cfgs(name) for name in CONFIGS}
    xs = {name: _inputs(cfgs[name][1]) for name in CONFIGS}
    dense = {name: _numpy_init(cfgs[name][1], 3 + i) for i, name in enumerate(CONFIGS)}
    pj, pcfg = _prune_cfgs()
    dense_p = _numpy_init(pcfg, 0)
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn")) as pool:
        jprune = pool.submit(ref.prune, dense_p)
        runs = pool.submit(ref.all_model_runs, {name: (CONFIGS[name], dense[name], xs[name])
                                                for name in CONFIGS})
        # the harness's model (the reference's init at its seed) and prompts
        jparams = jax.tree.map(np.asarray, ref.sc._model("hybrid")[1])
        prompts = ref.sc._workload("hybrid")[0]
        harness = pool.submit(ref.harness, jparams, prompts)
        hcfg = load_arch("recurrentgemma_9b").reduced(**CASE["reduced"])
        hmodel = params_from_numpy(hcfg, jparams, "cpu")
        served = {name: _serve(hcfg, hmodel, prompts, n, **kw)
                  for name, (n, kw) in SERVE_RUNS.items()}
        pmodel = params_from_numpy(pcfg, dense_p, "cpu")
        kw = dict(ocp_iters=ref.ITERS[0], icp_iters=ref.ITERS[1], workers=2)
        noperm = pruning.prune_model(pmodel, pcfg, method="noperm", **kw)
        with pytest.MonkeyPatch.context() as mp:
            reference_search_costs(mp)
            gyro = pruning.prune_model(pmodel, pcfg, rng=np.random.default_rng(0), **kw)
        models = {name: params_from_numpy(cfgs[name][1], dense[name], "cpu")
                  for name in CONFIGS}
        # the reference's params tree shapes, and how its Scheduler refuses
        # bucketing and prefix sharing on this family
        tree = jax.eval_shape(lambda: jzoo.init(jax.random.PRNGKey(0), cfgs["partial"][0]))
        refusals = {}
        for name, kw in REFUSED.items():
            with pytest.raises(ValueError) as e:
                jserve.Scheduler(ref.sc._model("hybrid")[0], None, **kw)
            refusals[name] = str(e.value)
        return dict(cfgs=cfgs, xs=xs, models=models, runs=runs.result(), tree=tree,
                    refusals=refusals,
                    harness=(hcfg, hmodel, prompts, harness.result()), served=served,
                    prune=(pcfg, pmodel, {"gyro": gyro, "noperm": noperm}, jprune.result()))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rglru_block_matches_with_and_without_a_cache(setup, name):
    cfg, model, x = setup["cfgs"][name][1], setup["models"][name], setup["xs"][name]
    ref = setup["runs"][name]
    blk = model.stack0[0].kind_rec
    xt = torch.from_numpy(x["x"])
    _close(ref["block"], rglru.rglru_block(blk, cfg, xt))
    state = {k: torch.from_numpy(v.copy()) for k, v in x["state"].items()}
    want_y, want_state = ref["block cached"]
    _close(want_y, rglru.rglru_block(blk, cfg, xt, state))
    assert set(state) == set(want_state)
    for k, v in state.items():
        _close(want_state[k], v)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill_and_decode_match(setup, name):
    cfg, model, x = setup["cfgs"][name][1], setup["models"][name], setup["xs"][name]
    ref = setup["runs"][name]
    toks = torch.from_numpy(x["tokens"])
    _close(ref["forward"], zoo.forward(model, cfg, toks))
    cache = zoo.make_cache(cfg, 2, MAX_SEQ, device="cpu")
    _close(ref["prefill"], zoo.prefill(model, cfg, toks, cache))
    logits = [zoo.decode_step(model, cfg, torch.from_numpy(t), cache) for t in x["decode"]]
    _close(ref["decode"], torch.stack(logits))
    # the same leaves in the same order and shapes: recurrent h float32,
    # conv and K/V in the model's dtype, positions int32
    want = jax.tree.leaves(ref["cache"])
    got = T.leaves(cache)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for w, g in zip(want, got):
        assert str(g.dtype).split(".")[-1] == w.dtype.name
        _close(w, g)
    assert [len(s) for s in model.stacks] == hybrid.counts(cfg)
    with pytest.raises(ValueError, match="cannot be length-bucketed"):
        zoo.prefill(model, cfg, toks, cache, n_rows=torch.tensor([7, 7]))


@pytest.mark.parametrize("s", [1, 2, 5, 37])
def test_scan_is_the_sequential_recurrence(s):
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, s, 8)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    h, want = h0, []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(torch.stack(want, dim=1), rglru.scan(a, b, h0), tol=1e-5)


def test_ring_decode_matches_full_history(setup):
    """`tests/test_models.py`'s window test on the port: a cache of the
    window alone (16 rows) holds a 20-token prefill (rolled into the
    ring), and the next decode step gives the full forward's logits."""
    cfg, model = setup["harness"][:2]
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (1, 24))
                            .astype(np.int32))
    full = zoo.logits_fn(model, cfg, zoo.forward(model, cfg, toks))
    cache = zoo.make_cache(cfg, 1, 16, device="cpu")
    assert cache[2]["k"].shape[2] == 16
    zoo.prefill(model, cfg, toks[:, :20], cache)
    assert cache[2]["kpos"][0, 0].tolist() == [16, 17, 18, 19] + list(range(4, 16))
    lg = zoo.decode_step(model, cfg, toks[:, 20:21], cache)
    np.testing.assert_allclose(lg.numpy(), full[:, 20].numpy(), rtol=3e-3, atol=3e-3)


def test_params_tree_round_trips_and_inits_on_the_pattern(setup):
    """`params_of` gives the reference's tree ({embed, stacks: [rec, rec,
    attn], ln_f, lm_head}, (n_j, ...) leaves); `from_params` serves views
    of it; the port's own init lays layer i at stack i % 3."""
    cfg, model = setup["cfgs"]["partial"][1], setup["models"]["partial"]
    params = zoo.params_of(cfg, model)
    tree = jax.tree.map(lambda t: t.numpy(), params)
    want = setup["tree"]
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert [t.shape for t in jax.tree.leaves(tree)] == [w.shape for w in jax.tree.leaves(want)]
    toks = torch.from_numpy(setup["xs"]["partial"]["tokens"])
    assert torch.equal(zoo.forward(zoo.from_params(cfg, params), cfg, toks),
                       zoo.forward(model, cfg, toks))
    own = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [len(s) for s in own.stacks] == [2, 2, 1]
    assert [layer.kind for s in own.stacks for layer in s] == ["rec"] * 4 + ["attn"]
    assert isinstance(own.stack1[1].kind_rec, rglru.RGLRUBlock)
    assert zoo.supports_spec_decode(cfg) is True
    assert zoo.supports_bucketed_prefill(cfg) is False
    assert zoo.supports_prefix_share(cfg) is False
    assert zoo.page_geometry(cfg, 256, 16) == {"view": 64, "page": 16, "n_bt": 4}


def test_compile_model_graph_containers_match_reference():
    jcfg, cfg = _prune_cfgs()
    got, want = compile_model_graph(cfg), jcompile_model_graph(jcfg)
    assert [c.tag for c in got.containers] == [c.tag for c in want.containers] == [
        "stack0", "stack1", "stack2"]
    for c, jc in zip(got.containers, want.containers):
        assert c.graph.order == jc.graph.order
        assert ({(e.src, e.dst, e.kind) for e in c.graph.edges}
                == {(e.src, e.dst, e.kind) for e in jc.graph.edges})
        assert ({p: n.can_permute_rows for p, n in c.graph.nodes.items()}
                == {p: n.can_permute_rows for p, n in jc.graph.nodes.items()})


@pytest.mark.parametrize("method", ["noperm", "gyro"])
def test_prune_model_masks_match_reference(setup, method):
    pcfg, _, pruned, jpruned = setup["prune"]
    permuted, masks, packed, rep = pruned[method]
    jmasks, jper_layer = jpruned[method]
    want = masks_from_numpy(pcfg, jmasks, "cpu")
    assert set(masks) == set(want) == {"stack0", "stack1", "stack2"}
    for key, n in zip(("stack0", "stack1", "stack2"), (2, 2, 1)):
        assert len(masks[key]) == len(want[key]) == n
        for got, ref in zip(masks[key], want[key]):
            assert set(got) == set(ref)
            for path, m in got.items():
                assert torch.equal(m, ref[path]), (key, path)
    assert [k for k, _ in rep.per_layer] == [k for k, _ in jper_layer]
    _close([r for _, r in jper_layer], [r for _, r in rep.per_layer])
    assert isinstance(packed.stack0[1].kind_rec.wa.w, PackedHiNM)
    assert isinstance(packed.stack2[0].kind_attn.attn.wv.w, PackedHiNM)
    assert not isinstance(packed.stack0[0].kind_rec.conv, PackedHiNM)


def test_packed_forward_equals_masked_forward(setup):
    pcfg, pmodel, pruned, _ = setup["prune"]
    permuted, masks, packed, _ = pruned["gyro"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, pcfg.vocab, (2, 9))
                            .astype(np.int32))
    # folding the permutations (wv's heads into wo, wu's rows into wd)
    # leaves the function as it was
    _close(zoo.forward(pmodel, pcfg, toks), zoo.forward(permuted, pcfg, toks), tol=1e-4)
    dense = zoo.forward(pruning.apply_masks(permuted, masks), pcfg, toks)
    _close(dense, zoo.forward(packed, pcfg, toks))
    # the mask tree walks the three position stacks, of unequal length
    tree = pruning.mask_tree(zoo.params_of(pcfg, permuted), masks)
    assert tree["stacks"][0]["kind_rec"]["wx"]["w"].shape == (2, 64, 64)
    assert tree["stacks"][2]["kind_attn"]["attn"]["wo"]["w"].shape == (1, 64, 64)
    assert tree["stacks"][1]["kind_rec"]["lam"] is None
    back = pruning.per_block(tree, list(masks["stack2"][0]), key="stack2")
    assert all(torch.equal(back[0][k], masks["stack2"][0][k]) for k in back[0])


def _isolated(cfg, model, prompt, n):
    """The port's own batch-1 prefill and greedy decode loop."""
    cache = zoo.make_cache(cfg, 1, MAX_SEQ, device="cpu")
    last = zoo.prefill(model, cfg, torch.from_numpy(prompt[None]), cache)
    toks = [int(zoo.logits_fn(model, cfg, last)[0, : cfg.vocab].argmax())]
    while len(toks) < n:
        lg = zoo.decode_step(model, cfg, torch.tensor([[toks[-1]]], dtype=torch.int32), cache)
        toks.append(int(lg[0, : cfg.vocab].argmax()))
    return toks


@pytest.mark.parametrize("layout", ["paged", "stripe"])
def test_scheduler_gives_reference_and_isolated_tokens(setup, layout):
    got, sched = setup["served"][layout]
    cfg, model, prompts, h = setup["harness"]
    assert got == h["tokens"]
    assert got == [_isolated(cfg, model, p, CASE["max_new"]) for p in prompts]
    assert sched.kv.paged is (layout == "paged") and sched.bucket is False
    assert sched.prefix is None
    if layout == "paged":
        # pages cover at most the ring: the 20-token prompt holds 2 (16 rows)
        assert sched.kv.view_len == 16 and sched.kv.pages_needed(26) == 2
        assert sched.kv.n_free_pages == sched.kv.n_alloc_pages
    admits = [e.data for e in sched.flight.events if e.kind == "admit"]
    assert [(a["bucket"], a["width"]) for a in admits] == [(8, 1), (20, 1), (12, 1)]


def _drop(events):
    return [serve.FlightEvent(seq, kind, t, {
        k: v for k, v in data.items() if k not in BY_DESIGN.get(kind, ())})
        for seq, kind, t, data in events]


def test_flight_record_equals_reference(setup):
    h = setup["harness"][3]
    got, sched = setup["served"]["paged"]
    assert got == h["tokens"]
    config = next(e for e in sched.flight.events if e.kind == "config")
    assert config.data["bucket"] is False and config.data["page"] == CASE["page"]
    rep = serve.diff_records(_drop(h["events"]), _drop(
        [(e.seq, e.kind, e.t, e.data) for e in sched.flight.events]))
    assert rep.equal, rep.render()
    assert rep.n_a == rep.n_b == len(sched.flight.events)


@pytest.mark.parametrize("layout", ["paged", "stripe"])
@pytest.mark.parametrize("fused", [True, False])
def test_spec_equals_plain_and_reference(setup, fused, layout):
    """Sequential verify, fused and unfused: spec streams equal the
    reference's (which the harness holds equal to its own spec runs') and,
    paged, over LONG_NEW tokens with drafts accepted in part (the
    recurrent state selected after 1 to 3 of 4 steps, the ring wrapping
    mid-verify), the port's plain greedy streams."""
    mode = "fused" if fused else "unfused"
    got, sched = setup["served"][f"spec {mode} {layout}"]
    assert got == setup["harness"][3]["tokens"]
    assert sched.stats.verify_steps > 0
    assert sched.kv.n_free_pages == sched.kv.n_alloc_pages
    if not fused:
        # the unfused chain's rollback read the verify program's undo
        # buffers: one per stack, every leaf step-stacked (k + 1, ...)
        assert [next(iter(u.values())).shape[0] for u in sched._verify_undo] == [4] * 3
    if layout == "paged":
        got, sched = setup["served"][f"long spec {mode}"]
        assert got == setup["served"]["long"][0]
        assert 0 < sched.stats.draft_accepted < sched.stats.draft_proposed


@pytest.mark.parametrize("layout", ["paged", "stripe"])
def test_rollback_helpers_match_reference(setup, layout):
    """Four decode writes on a ring that wraps mid-verify (`torch_hybrid_
    ref.ring`), each after `snapshot_attn_row`, then `restore_attn_rows`
    keeping 0, 2 and 4 steps: the port's snapshots and restored cache equal
    the reference's exactly, and lane 0 (nothing kept) is the cache before
    the verify.  `select_state` equals the reference's too."""
    case, want = ref.ring(layout), setup["harness"][3]["rollbacks"][layout]
    cache = {n: torch.from_numpy(a.copy()) for n, a in case["cache"].items()}
    pos0 = cache["pos"][0].clone()
    snaps = []
    for i in range(4):
        snaps.append(paging.snapshot_attn_row(cache, window=True))
        ii, jj = paging._row_loc_at(cache, cache["pos"][0], True)
        for name in "kv":
            cache[name][:, ii, jj] = torch.from_numpy(case["rows"][name][i])
        cache["kpos"][:, ii, jj] = cache["pos"][0]
        cache["pos"] += 1
    for got, w in zip(snaps, want["snaps"]):
        for name in ("k", "v", "kpos"):
            _close(w[name], got[name], tol=0)
    stack = T.map(lambda *xs: torch.stack(xs), snaps[0], *snaps[1:])
    keep = torch.tensor(ref.KEEP, dtype=torch.int32)
    paging.restore_attn_rows(cache, stack, pos0, keep, 4, window=True)
    for name in cache:
        _close(want["restored"][name], cache[name], tol=0)
    assert cache["pos"][0].tolist() == [p + k for p, k in zip(ref.RING_POS, ref.KEEP)]
    start = {n: torch.from_numpy(a) for n, a in case["cache"].items()}
    for name in ("k", "v", "kpos"):
        if layout == "stripe":
            assert torch.equal(cache[name][:, 0], start[name][:, 0]), name
        else:
            lane0 = start["bt"][0, 0].long()
            assert torch.equal(cache[name][:, lane0], start[name][:, lane0]), name
    got = paging.select_state(torch.from_numpy(case["states"]), torch.from_numpy(case["final"]),
                              keep)
    _close(want["state"], got, tol=0)
    assert torch.equal(got[:, 2], torch.from_numpy(case["final"][:, 2]))


def test_refusals_and_pristine_slots_as_the_reference(setup):
    """`bucket=True` and prefix sharing are refused with the reference's
    messages; a released slot's recurrent state and block table are
    pristine again, and `reset_all` keeps the pool's storage."""
    cfg, model, prompts, _ = setup["harness"]
    for name, match in (("bucket", "prefill cannot be length-bucketed"),
                        ("prefix sharing", "prefix sharing needs")):
        with pytest.raises(ValueError, match=match) as got:
            Scheduler(cfg, model, device="cpu", **REFUSED[name])
        assert match in setup["refusals"][name]
        if name == "bucket":
            assert str(got.value) == setup["refusals"][name]
    kv = SlotKVCache(cfg, 3, MAX_SEQ, page=8, device="cpu")
    pristine = zoo.make_cache(cfg, 3, MAX_SEQ, page=8, n_pages=kv.n_pages, device="cpu")
    st = kv.template(1)
    zoo.prefill(model, cfg, torch.from_numpy(prompts[1][None]), st)
    slot = kv.acquire()
    kv.insert(slot, st, 20, reserve=26)
    assert not torch.equal(kv.cache[0]["h"][:, slot], pristine[0]["h"][:, slot])
    storage = [t.data_ptr() for t in T.leaves(kv.cache)]
    kv.release(slot)
    # a freed page keeps its stale K/V bytes (its kpos rows mask them)
    for got, want in zip(kv.cache, pristine):
        for name in set(got) - ({"k", "v"} if paging.is_paged(got) else set()):
            assert torch.equal(got[name], want[name]), name
    kv.reset_all()
    assert [t.data_ptr() for t in T.leaves(kv.cache)] == storage
