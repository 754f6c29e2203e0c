"""Port parity: the recurrent ssm family (`repro_torch.models.xlstm`,
`repro_torch.models.xlstm_model`, xlstm-125m) against `repro.models.xlstm`
and `repro.models.xlstm_model`, on the same numpy inputs, on the CPU.

- `mlstm_block` and `slstm_block`, with and without a cache, and the
  model's eval forward, prefill and decode steps agree within 1e-5 (f32;
  sum order only) at `reduced()` and at the reference serving harness's
  case (`tests/serve_conformance.py`, "ssm": `reduced(n_layers=2,
  d_model=64, n_heads=4, vocab=128)`, whose `head_dim` 32 is not
  d_model // n_heads), the reference's weights carried across by
  `convert.params_from_numpy`.
- `compile_model_graph` gives the reference's ``stack0`` / ``stack1``
  containers; `prune_model` on `tests/test_prune_model.py`'s ssm config
  gives the reference's masks per stack (noperm, and gyro 2/2 scored with
  the reference's own cost helpers, `reference_search_costs`); the packed
  forward equals the masked one.
- The harness's case through the port's `Scheduler` gives isolated
  decoding's tokens (the port's batch-1 prefill and greedy loop), a
  requested page falling back to stripes, and a flight record equal to
  the reference scheduler's, event for event (tokens included, which the
  harness holds to its own isolated decoding), after dropping the
  paged-attention backend names that differ by design.
- The pool's pristine state is the family's: after a release and after
  `reset_all` the state equals `make_cache`'s (mLSTM's m at -1e30,
  sLSTM's n at 1), and a reused prefill template starts pristine.

The harness case's weights are the reference's init at its seed; the
other configs' are the port's seeded init laid out as the reference's
params tree (`zoo.params_of`).  The reference's compiles run on threads
beside the port's work.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve_conformance as sc
from repro import serve as jserve
from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import load_arch as jload_arch
from repro.core.types import HiNMConfig as JHiNMConfig
from repro.models import xlstm as jxlstm
from repro.models import zoo as jzoo
from repro.perm import compile_model_graph as jcompile_model_graph
from repro.train import pruning as jpruning
from repro_torch import serve
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, load_arch
from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.core.types import HiNMConfig, PackedHiNM
from repro_torch.models import xlstm, zoo
from repro_torch.perm import compile_model_graph
from repro_torch.serve import Request, SamplingParams, Scheduler, ServeEngine, SpecConfig
from repro_torch.serve.kv import SlotKVCache
from repro_torch.train import pruning
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_train_ref import reference_search_costs

TOL = 1e-5
CASE = sc._CASES["ssm"]
MAX_SEQ = sc.MAX_SEQ
ITERS = (2, 2)
# tests/test_prune_model.py's ssm config
PRUNE = dict(name="ssm", family="ssm", block_pattern=("mlstm", "slstm"), n_layers=2,
             d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=256, head_dim=16, max_seq=64)
# the harness's case, and `reduced()` at its defaults (4 layers, d 128)
CONFIGS = {"harness": CASE["reduced"], "reduced": {}}
# event fields whose values differ between the packages by design (see
# tests/test_torch_flightrec.py)
BY_DESIGN = {"config": ("paged_attn",), "dispatch": ("requested", "backend", "defer")}


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cfgs(name):
    return (jload_arch("xlstm_125m").reduced(**CONFIGS[name]),
            load_arch("xlstm_125m").reduced(**CONFIGS[name]))


def _inputs(cfg):
    """A block input (2, 5, D), a random state of each block kind, the
    forward's and the prefill's tokens and two decode steps' tokens."""
    rng = np.random.default_rng(43)
    d, h, dk = cfg.d_model, cfg.n_heads, cfg.d_model // cfg.n_heads

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(x=normal(2, 5, d),
                mlstm=dict(c=normal(2, h, dk, dk), n=normal(2, h, dk), m=normal(2, h)),
                slstm=dict(c=normal(2, d), n=np.abs(normal(2, d)) + 0.5, h=normal(2, d),
                           m=normal(2, d)),
                tokens=rng.integers(0, cfg.vocab, (2, 7)).astype(np.int32),
                decode=rng.integers(0, cfg.vocab, (2, 2, 1)).astype(np.int32))


def _reference_runs(jcfg, params, x):
    """In one jitted program: both blocks of period 0 with and without the
    random state, the eval forward, a prefill from the pristine cache and
    two decode steps (logits and the state after them)."""
    def run(params, x):
        out = {}
        for j, kind in enumerate(("mlstm", "slstm")):
            layer = jax.tree.map(lambda a: a[0], params["stacks"][j])
            fn = jxlstm.mlstm_block if kind == "mlstm" else jxlstm.slstm_block
            out[kind] = fn(layer, jcfg, x["x"])[0]
            out[f"{kind} cached"] = fn(layer, jcfg, x["x"], x[kind])
        out["forward"] = jzoo.forward(params, jcfg, x["tokens"])
        cache = jzoo.make_cache(jcfg, 2, MAX_SEQ)
        out["prefill"], cache = jzoo.prefill(params, jcfg, x["tokens"], cache)
        logits = []
        for tok in x["decode"]:
            lg, cache = jzoo.decode_step(params, jcfg, tok, cache)
            logits.append(lg)
        out["decode"], out["cache"] = jnp.stack(logits), cache
        return out

    return jax.tree.map(np.asarray, jax.jit(run)(params, jax.tree.map(jnp.asarray, x)))


def _requests(mod, prompts):
    return [mod.Request(rid=i, prompt=p, arrival=i,
                        params=mod.SamplingParams(max_new_tokens=CASE["max_new"]))
            for i, p in enumerate(prompts)]


SCHED = dict(max_slots=4, max_seq=MAX_SEQ, decode_chunk=4, page=CASE["page"], flightrec=True)


def _reference_sched(jcfg, params):
    """The harness's `scheduler_tokens("ssm", "paged")`: its recorded run."""
    sched = jserve.Scheduler(jcfg, params, **SCHED)
    reqs = _requests(jserve, sc._workload("ssm")[0])
    sched.run(reqs)
    return sched, reqs


def _reference_harness(jcfg, x):
    """The harness's model (the reference's init at its seed), then its
    runs and its recorded scheduler run."""
    jparams = sc._model("ssm")[1]
    return jparams, _reference_runs(jcfg, jparams, x), _reference_sched(jcfg, jparams)


def _prune_cfgs():
    hinm = dict(v=8, n=2, m=4, vector_sparsity=0.5)
    return (JArchConfig(**PRUNE, dtype=jnp.float32, hinm=JHiNMConfig(**hinm)),
            ArchConfig(**PRUNE, dtype=torch.float32, hinm=HiNMConfig(**hinm)))


def _reference_prune(jcfg, params):
    out = {}
    for method in ("gyro", "noperm"):
        _, masks, _, rep = jpruning.prune_model(params, jcfg, method=method,
                                                ocp_iters=ITERS[0], icp_iters=ITERS[1],
                                                workers=4)
        out[method] = (jax.tree.map(np.asarray, masks), rep)
    return out


def _numpy_init(cfg, seed):
    """The port's seeded init as the reference's params tree, numpy."""
    model = zoo.init(cfg, torch.Generator().manual_seed(seed), "cpu")
    return jax.tree.map(lambda t: t.numpy(), zoo.params_of(cfg, model))


@pytest.fixture(scope="module")
def setup():
    """Each config's weights and reference runs, the harness's recorded
    scheduler run and the reference's prune (gyro and noperm), on threads
    beside the port's model builds and prunes."""
    cfgs = {name: _cfgs(name) for name in CONFIGS}
    xs = {name: _inputs(cfgs[name][1]) for name in CONFIGS}
    pj, pcfg = _prune_cfgs()
    dense_p, dense_r = _numpy_init(pcfg, 0), _numpy_init(cfgs["reduced"][1], 3)
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        harness = ex.submit(_reference_harness, cfgs["harness"][0], xs["harness"])
        jprune = ex.submit(_reference_prune, pj, jax.tree.map(jnp.asarray, dense_p))
        runs_r = ex.submit(_reference_runs, cfgs["reduced"][0], jax.tree.map(jnp.asarray, dense_r),
                           xs["reduced"])
        pmodel = params_from_numpy(pcfg, dense_p, "cpu")
        kw = dict(ocp_iters=ITERS[0], icp_iters=ITERS[1], workers=2)
        noperm = pruning.prune_model(pmodel, pcfg, method="noperm", **kw)
        # the replay scores with the reference's helpers: after its prune,
        # whose compiles it shares
        jmasks = jprune.result()
        with pytest.MonkeyPatch.context() as mp:
            reference_search_costs(mp)
            gyro = pruning.prune_model(pmodel, pcfg, rng=np.random.default_rng(0), **kw)
        jparams, runs_h, jsched = harness.result()
        models = {"harness": params_from_numpy(cfgs["harness"][1],
                                               jax.tree.map(np.asarray, jparams), "cpu"),
                  "reduced": params_from_numpy(cfgs["reduced"][1], dense_r, "cpu")}
        return dict(cfgs=cfgs, models=models, xs=xs,
                    runs={"harness": runs_h, "reduced": runs_r.result()}, jsched=jsched,
                    prune=(pcfg, pmodel, {"gyro": gyro, "noperm": noperm}, jmasks))


def _state(x, kind):
    return {k: torch.from_numpy(v.copy()) for k, v in x[kind].items()}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_match_with_and_without_a_cache(setup, name, kind):
    cfg, model, x = setup["cfgs"][name][1], setup["models"][name], setup["xs"][name]
    ref = setup["runs"][name]
    blk = getattr(model, "stack0" if kind == "mlstm" else "stack1")[0]
    fn = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    xt = torch.from_numpy(x["x"])
    _close(ref[kind], fn(blk, cfg, xt))
    state = _state(x, kind)
    want_y, want_state = ref[f"{kind} cached"]
    _close(want_y, fn(blk, cfg, xt, state))
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
    # the same leaves in the same order (jax.tree order: positions, then
    # names sorted), every one (n_p, B, ...) float32
    want = jax.tree.leaves(ref["cache"])
    got = T.leaves(cache)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.dtype == torch.float32 for g in got)
    for w, g in zip(want, got):
        _close(w, g)
    assert T.leaves(zoo.cache_batch_axes(cfg, cache)) == [1] * len(got)
    with pytest.raises(ValueError, match="cannot be length-bucketed"):
        zoo.prefill(model, cfg, toks, cache, n_rows=torch.tensor([7, 7]))


def test_head_width_is_d_model_over_heads(setup):
    cfg = setup["cfgs"]["harness"][1]
    assert (cfg.head_dim, xlstm.head_dim(cfg)) == (32, 16)
    cache = zoo.make_cache(cfg, 3, MAX_SEQ, device="cpu")
    assert cache[0]["c"].shape == (1, 3, 4, 16, 16)
    assert setup["models"]["harness"].stack1[0].r.shape == (4, 4, 16, 16)


def test_params_tree_round_trips_and_inits_on_the_pattern(setup):
    """`params_of` gives the reference's tree ({embed, stacks: [mLSTM,
    sLSTM], ln_f, lm_head}, (n_p, ...) leaves); `from_params` serves views
    of it; the port's own init lays layer i at period i // 2."""
    cfg, model = setup["cfgs"]["reduced"][1], setup["models"]["reduced"]
    jcfg = setup["cfgs"]["reduced"][0]
    params = zoo.params_of(cfg, model)
    want = jax.eval_shape(lambda: jzoo.init(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(jax.tree.map(lambda t: t.numpy(), params)) == \
        jax.tree.structure(want)
    assert [tuple(t.shape) for t in jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), params))] \
        == [w.shape for w in jax.tree.leaves(want)]
    toks = torch.from_numpy(setup["xs"]["reduced"]["tokens"])
    assert torch.equal(zoo.forward(zoo.from_params(cfg, params), cfg, toks),
                       zoo.forward(model, cfg, toks))
    own = zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [len(s) for s in own.stacks] == [2, 2]
    assert isinstance(own.stack0[1], xlstm.MLSTMBlock)
    assert isinstance(own.stack1[0], xlstm.SLSTMBlock)
    assert zoo.supports_spec_decode(cfg) is False
    assert zoo.supports_bucketed_prefill(cfg) is False
    assert zoo.page_geometry(cfg, MAX_SEQ, 16) is None


def test_compile_model_graph_containers_match_reference():
    jcfg, cfg = _prune_cfgs()
    got, want = compile_model_graph(cfg), jcompile_model_graph(jcfg)
    assert [c.tag for c in got.containers] == [c.tag for c in want.containers] == [
        "stack0", "stack1"]
    for c, jc in zip(got.containers, want.containers):
        assert c.graph.order == jc.graph.order
        assert ({(e.src, e.dst, e.kind) for e in c.graph.edges}
                == {(e.src, e.dst, e.kind) for e in jc.graph.edges})
        assert all(not n.can_permute_rows for n in c.graph.nodes.values())
    assert [n.path for _, n in got.instances()] == [
        "wq", "wk", "wv", "wo_gate", "wout", "wz", "wi", "wf", "wo", "wout"]


@pytest.mark.parametrize("method", ["noperm", "gyro"])
def test_prune_model_masks_match_reference(setup, method):
    pcfg, _, pruned, jpruned = setup["prune"]
    permuted, masks, packed, rep = pruned[method]
    jmasks, jrep = jpruned[method]
    want = masks_from_numpy(pcfg, jmasks, "cpu")
    assert set(masks) == set(want) == {"stack0", "stack1"}
    for key in ("stack0", "stack1"):
        assert len(masks[key]) == 1
        for got, ref in zip(masks[key], want[key]):
            assert set(got) == set(ref)
            for path, m in got.items():
                assert torch.equal(m, ref[path]), (key, path)
    assert [k for k, _ in rep.per_layer] == [k for k, _ in jrep.per_layer]
    _close([r for _, r in jrep.per_layer], [r for _, r in rep.per_layer])
    assert sorted(rep.out_perms) == sorted(f"stack{j}[0]/{n}" for j, names in enumerate(
        (("wq", "wk", "wv", "wo_gate", "wout"), ("wz", "wi", "wf", "wo", "wout"))) for n in names)
    assert isinstance(packed.stack1[0].wz.w, PackedHiNM)
    assert not isinstance(packed.stack0[0].wi.w, PackedHiNM)   # the per-head gates


def test_packed_forward_equals_masked_forward(setup):
    pcfg, pmodel, pruned, _ = setup["prune"]
    permuted, masks, packed, _ = pruned["gyro"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, pcfg.vocab, (2, 9))
                            .astype(np.int32))
    # no row may move: folding is the identity, the function unchanged
    _close(zoo.forward(pmodel, pcfg, toks), zoo.forward(permuted, pcfg, toks))
    dense = zoo.forward(pruning.apply_masks(permuted, masks), pcfg, toks)
    _close(dense, zoo.forward(packed, pcfg, toks))
    # the serving path's `pack_params` packs noperm: of noperm's masked
    # model it makes noperm's packed one
    _, nmasks, npacked, _ = pruned["noperm"]
    again = zoo.pack_params(pcfg, pruning.apply_masks(pmodel, nmasks))
    _close(zoo.forward(npacked, pcfg, toks), zoo.forward(again, pcfg, toks))
    # the mask tree walks the position stacks, and back
    tree = pruning.mask_tree(zoo.params_of(pcfg, permuted), masks)
    assert tree["stacks"][1]["wz"]["w"].shape == (1, 64, 64)
    assert tree["stacks"][0]["wi"]["w"] is None and tree["stacks"][1]["r"] is None
    back = pruning.per_block(tree, list(masks["stack1"][0]), key="stack1")
    assert all(torch.equal(back[0][k], masks["stack1"][0][k]) for k in back[0])


def _serve(setup, **kw):
    cfg, model = setup["cfgs"]["harness"][1], setup["models"]["harness"]
    sched = Scheduler(cfg, model, **{**SCHED, **kw}, device="cpu")
    reqs = _requests(serve, sc._workload("ssm")[0])
    sched.run(reqs)
    return [r.tokens for r in reqs], sched


@pytest.mark.parametrize("layout", ["paged", "stripe"])
def test_scheduler_gives_isolated_tokens(setup, layout):
    kw = {} if layout == "paged" else dict(page=None, bucket=False)
    got, sched = _serve(setup, **kw)
    cfg, model = setup["cfgs"]["harness"][1], setup["models"]["harness"]
    assert got == [_isolated(cfg, model, p, CASE["max_new"]) for p in sc._workload("ssm")[0]]
    # a requested page falls back to stripes; nothing is shared or paged
    assert not sched.kv.paged and sched.prefix is None and sched.bucket is False
    assert sched.paged_attn == "off"
    admits = [e.data for e in sched.flight.events if e.kind == "admit"]
    assert [(a["bucket"], a["width"]) for a in admits] == [(5, 1), (9, 1), (7, 1)]


def test_flight_record_equals_reference(setup):
    jsched, jreqs = setup["jsched"]
    got, sched = _serve(setup)
    assert got == [r.tokens for r in jreqs]
    config = next(e for e in sched.flight.events if e.kind == "config")
    assert config.data["bucket"] is False and config.data["page"] is None

    def drop(events):
        return [serve.FlightEvent(ev.seq, ev.kind, ev.t, {
            k: v for k, v in ev.data.items() if k not in BY_DESIGN.get(ev.kind, ())})
            for ev in events]

    rep = serve.diff_records(drop(jsched.flight.events), drop(sched.flight.events))
    assert rep.equal, rep.render()
    assert rep.n_a == rep.n_b == len(sched.flight.events)


def _isolated(cfg, model, prompt, n):
    """The port's own batch-1 prefill and greedy decode loop."""
    cache = zoo.make_cache(cfg, 1, MAX_SEQ, device="cpu")
    last = zoo.prefill(model, cfg, torch.from_numpy(prompt[None]), cache)
    toks = [int(zoo.logits_fn(model, cfg, last)[0, : cfg.vocab].argmax())]
    while len(toks) < n:
        lg = zoo.decode_step(model, cfg, torch.tensor([[toks[-1]]], dtype=torch.int32), cache)
        toks.append(int(lg[0, : cfg.vocab].argmax()))
    return toks


def test_exact_length_groups_reuse_a_pristine_template(setup):
    """Requests of one length admitted apart share one prefill program and
    its template; each prefill still starts from the pristine state (a
    stale one would enter the next group's prompts), and a group of two
    equal lengths prefills unpadded at width 2."""
    cfg, model = setup["cfgs"]["harness"][1], setup["models"]["harness"]
    rng = np.random.default_rng(8)
    lens, arrivals = (6, 6, 6, 6), (0, 0, 3, 6)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    sched = Scheduler(cfg, model, max_slots=2, max_seq=MAX_SEQ, decode_chunk=2, device="cpu",
                      flightrec=True)
    reqs = [Request(rid=i, prompt=p, arrival=a, params=SamplingParams(max_new_tokens=5))
            for i, (p, a) in enumerate(zip(prompts, arrivals))]
    sched.run(reqs)
    assert [r.tokens for r in reqs] == [_isolated(cfg, model, p, 5) for p in prompts]
    admits = [(e.data["bucket"], e.data["width"]) for e in sched.flight.events
              if e.kind == "admit"]
    assert admits == [(6, 2), (6, 1), (6, 1)]
    assert sorted(k[:2] for k in sched._prefill_io) == [(6, 1), (6, 2)]


def test_pool_state_is_the_family_pristine_state(setup):
    """`release` and `reset_all` leave what `make_cache` makes: the family's
    own pristine values, not zeros."""
    cfg, model = setup["cfgs"]["harness"][1], setup["models"]["harness"]
    kv = SlotKVCache(cfg, 3, MAX_SEQ, page=16, device="cpu")
    assert not kv.paged
    pristine = zoo.make_cache(cfg, 3, MAX_SEQ, device="cpu")
    assert bool((pristine[0]["m"] == torch.tensor(-1e30)).all())
    assert bool((pristine[1]["n"] == 1).all())
    st = kv.template(2)
    zoo.prefill(model, cfg, torch.from_numpy(setup["xs"]["harness"]["tokens"]), st)
    for slot in (kv.acquire(), kv.acquire()):
        kv.insert(slot, st, 7, row=slot)
    zoo.decode_step(model, cfg, torch.zeros((3, 1), dtype=torch.int32), kv.cache)
    kv.release(0)
    for got, want in zip(T.leaves(kv.cache), T.leaves(pristine)):
        assert torch.equal(got[:, 0], want[:, 0])
        assert not torch.equal(got[:, 1], want[:, 1])
    storage = [t.data_ptr() for t in T.leaves(kv.cache)]
    kv.reset_all()
    assert [t.data_ptr() for t in T.leaves(kv.cache)] == storage
    for got, want in zip(T.leaves(kv.cache), T.leaves(pristine)):
        assert torch.equal(got, want)
    # a used prefill template rewinds to the same state
    zoo.rewind_cache(cfg, st)
    for got, want in zip(T.leaves(st), T.leaves(zoo.make_cache(cfg, 2, MAX_SEQ, device="cpu"))):
        assert torch.equal(got, want)


def test_serve_engine_generate_falls_back_to_stripes(setup):
    cfg, model = setup["cfgs"]["harness"][1], setup["models"]["harness"]
    prompts = np.stack([p[:5] for p in sc._workload("ssm")[0]])
    eng = ServeEngine(cfg, model, max_seq=MAX_SEQ, device="cpu")
    got, stats = eng.generate(prompts, max_new_tokens=4)
    assert not eng._sched.kv.paged
    assert got.tolist() == [_isolated(cfg, model, p, 4) for p in prompts]
    assert stats.prefill_rows == 15


def test_spec_and_bucketing_refused_as_the_reference(setup):
    cfg, model = setup["cfgs"]["harness"][1], setup["models"]["harness"]
    jcfg = setup["cfgs"]["harness"][0]
    for kw, match in ((dict(spec=SpecConfig(k=3)), "no speculative verify path"),
                      (dict(bucket=True), "prefill cannot be length-bucketed")):
        with pytest.raises(ValueError, match=match) as got:
            Scheduler(cfg, model, device="cpu", **kw)
        jkw = dict(spec=jserve.SpecConfig(k=3)) if "spec" in kw else kw
        with pytest.raises(ValueError, match=match) as want:
            jserve.Scheduler(jcfg, None, **jkw)
        assert str(got.value) == str(want.value)
