"""Port parity: the encoder-decoder family (`repro_torch.models.encdec`,
seamless-m4t-medium) against `repro.models.encdec`, on the reference
serving harness's own case (`tests/serve_conformance.py`, "encdec":
`reduced()`, the reference's init at seed 37, prompts of 5 / 9 / 7 tokens,
6 frames each, 6 new tokens, page 16, `t_enc` 6), its weights carried
across by `convert.params_from_numpy`.

- `encode`, the eval forward, a bucketed prefill with frames into the
  stripe template, its rows inserted into a paged pool, decode steps, a
  4-row `verify_step` and `cache_rollback` agree within 1e-4 (sum-order
  differences only, the tolerance `tests/test_torch_model.py` holds the
  dense family to); `copy_slot_row` and `reset_slot_row` equal the
  reference's exactly; the serving cross-attention's rows do not depend
  on how many the call holds.
- The port's `Scheduler`, paged and stripe, gives the harness's
  `isolated_tokens("encdec")`: `greedy_isolated`, the reference's batch-1
  prefill and greedy decode loop, here with its two functions under
  `jax.jit` (one compile each instead of a scan traced per call); n-gram
  speculation (`SpecConfig(k=3)`) gives the same streams, and
  `ServeEngine.generate(embeds=)` the port's own batch-1 greedy loop.
- `compile_model_graph` gives the reference's ``enc`` / ``dec``
  containers on `tests/test_perm_graph.py`'s encdec config; `prune_model`
  (gyro 2/2) on `tests/test_prune_model.py`'s encdec config gives the
  reference's masks per stack when the search scores with the reference's
  own cost helpers (`reference_search_costs`), and its packed forward
  equals its masked forward within 1e-4.

The reference's compiles (its functions, the isolated decode, its prune)
run on threads beside the port's work.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve_conformance as sc
from repro.configs.base import ArchConfig as JArchConfig
from repro.core.types import HiNMConfig as JHiNMConfig
from repro.models import encdec as jencdec
from repro.models import paging as jpaging
from repro.models import zoo as jzoo
from repro.perm import compile_model_graph as jcompile_model_graph
from repro.train import pruning as jpruning
from repro_torch.configs.base import ArchConfig, load_arch
from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.core.types import HiNMConfig, PackedHiNM
from repro_torch.models import encdec, paging, zoo
from repro_torch.perm import compile_model_graph
from repro_torch.serve import (ModelDrafter, Request, SamplingParams, Scheduler,
                               ServeEngine, SpecConfig)
from repro_torch.train import pruning
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_train_ref import reference_search_costs

TOL = 1e-4
CASE = sc._CASES["encdec"]
MAX_SEQ = sc.MAX_SEQ
T_ENC = CASE["cache_kw"]["t_enc"]
N_SLOTS, N_PAGES = 3, paging.N_RESERVED + 12
ITERS = (2, 2)
# tests/test_prune_model.py's encdec config (its BASE sizes)
PRUNE = dict(name="encdec", family="encdec", n_layers=2, n_enc_layers=2, d_model=64,
             n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16, max_seq=64)

j_encode = jax.jit(jencdec.encode, static_argnums=1)
j_forward = jax.jit(jzoo.forward, static_argnums=1)
j_prefill = jax.jit(jzoo.prefill, static_argnums=1)
j_decode = jax.jit(jzoo.decode_step, static_argnums=1)
j_verify = jax.jit(jzoo.verify_step, static_argnums=1)
j_insert = jax.jit(jzoo.paged_insert, static_argnums=0)
j_rollback = jax.jit(jzoo.cache_rollback, static_argnums=(0, 5))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                               rtol=tol, atol=tol)


def _inputs(cfg):
    """Two lanes of frames (6 and 4 rows valid of the pool's 6: the second
    lane's frames come from a group of 4-frame requests), a bucketed
    decoder prompt of 5 / 8 rows, their pages, two decode steps, a 4-row
    verify and its accept counts."""
    rng = np.random.default_rng(37)
    toks = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    n_rows = np.array([5, 8], np.int32)
    toks[0, 5:] = 0
    n_bt = MAX_SEQ // CASE["page"]
    inserts = []
    for row, slot, pages in ((0, 2, [5, 9]), (1, 0, [3, 12])):
        ids = np.full((n_bt,), paging.SCRATCH_PAGE, np.int32)
        bt_row = np.full((n_bt,), paging.SENTINEL_PAGE, np.int32)
        ids[:2] = bt_row[:2] = pages
        inserts.append((row, slot, ids, bt_row))
    return dict(frames=rng.standard_normal((2, T_ENC, cfg.d_model)).astype(np.float32),
                short=rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32),
                tokens=toks, n_rows=n_rows, inserts=inserts,
                forward=rng.integers(0, cfg.vocab, (2, 7)).astype(np.int32),
                decode=rng.integers(0, cfg.vocab, (2, N_SLOTS, 1)).astype(np.int32),
                verify=rng.integers(0, cfg.vocab, (N_SLOTS, 4)).astype(np.int32),
                keep=np.array([2, 0, 4], np.int32))


def _reference_runs(jcfg, params, x):
    """encode, forward, the two prefills (6 and 4 frames) inserted into a
    3-slot pool (slot 1 idle), decode steps, the verify and its rollback,
    then one more decode step, all as numpy."""
    out = {"encode": j_encode(params, jcfg, jnp.asarray(x["frames"])),
           "forward": j_forward(params, jcfg, jnp.asarray(x["forward"]),
                                embeds=jnp.asarray(x["frames"]))}
    pool = jzoo.make_cache(jcfg, N_SLOTS, MAX_SEQ, page=CASE["page"], n_pages=N_PAGES,
                           t_enc=T_ENC)
    lasts = []
    for frames, (row, slot, ids, bt_row) in zip(("frames", "short"), x["inserts"]):
        st = jzoo.make_cache(jcfg, 2, MAX_SEQ, t_enc=T_ENC)
        last, st = j_prefill(params, jcfg, jnp.asarray(x["tokens"]), st,
                             embeds=jnp.asarray(x[frames]), n_rows=jnp.asarray(x["n_rows"]))
        lasts.append(last)
        pool = j_insert(jcfg, pool, st, slot, row, jnp.asarray(ids), jnp.asarray(bt_row),
                        np.int32(2))
    out["last"] = np.stack(lasts)
    out["pool_enc"] = {k: pool[k] for k in ("enc_out", "enc_len")}
    logits = []
    for tok in x["decode"]:
        lg, pool = j_decode(params, jcfg, jnp.asarray(tok), pool)
        logits.append(lg)
    out["decode"] = np.stack(logits)
    pos0 = pool["self"]["pos"][0]
    out["verify"], pool, undo = j_verify(params, jcfg, jnp.asarray(x["verify"]), pool)
    pool = j_rollback(jcfg, pool, undo, pos0, jnp.asarray(x["keep"]), 4)
    out["after"], pool = j_decode(params, jcfg, jnp.asarray(x["decode"][0]), pool)
    out["pos"], out["kpos"] = pool["self"]["pos"], pool["self"]["kpos"]
    return jax.tree.map(np.asarray, out)


def _reference_isolated(jcfg, params):
    """`serve_conformance.isolated_tokens("encdec")`: `greedy_isolated` on
    every request of the harness's workload, its prefill and decode step
    under jit."""
    prompts, embeds = sc._workload("encdec")
    out = []
    for p, e in zip(prompts, embeds):
        cache = jzoo.make_cache(jcfg, 1, MAX_SEQ, **CASE["cache_kw"])
        last, cache = j_prefill(params, jcfg, jnp.asarray(p[None]), cache,
                                embeds=jnp.asarray(e[None]))
        toks = [int(jnp.argmax(jzoo.logits_fn(params, jcfg, last)[:, : jcfg.vocab], -1)[0])]
        while len(toks) < CASE["max_new"]:
            lg, cache = j_decode(params, jcfg, jnp.asarray([[toks[-1]]], jnp.int32), cache)
            toks.append(int(jnp.argmax(lg[:, : jcfg.vocab], -1)[0]))
        out.append(toks)
    return out


def _prune_cfgs():
    jcfg = JArchConfig(**PRUNE, dtype=jnp.float32,
                       hinm=JHiNMConfig(v=8, n=2, m=4, vector_sparsity=0.5))
    cfg = ArchConfig(**PRUNE, dtype=torch.float32,
                     hinm=HiNMConfig(v=8, n=2, m=4, vector_sparsity=0.5))
    return jcfg, cfg


def _reference_prune(jcfg, params):
    _, masks, _, rep = jpruning.prune_model(params, jcfg, ocp_iters=ITERS[0],
                                            icp_iters=ITERS[1], workers=8)
    return jax.tree.map(np.asarray, masks), rep


@pytest.fixture(scope="module")
def setup():
    jcfg, jparams = sc._model("encdec")
    cfg = load_arch(CASE["arch"]).reduced(**CASE["reduced"])
    params = jax.tree.map(np.asarray, jparams)
    x = _inputs(cfg)
    pj, pcfg = _prune_cfgs()
    # tests/test_prune_model.py's init of its configs
    jdense_p = jzoo.init(jax.random.PRNGKey(0), pj)
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        jprune = ex.submit(_reference_prune, pj, jdense_p)
        runs = ex.submit(_reference_runs, jcfg, jparams, x)
        isolated = ex.submit(_reference_isolated, jcfg, jparams)
        model = params_from_numpy(cfg, params, "cpu")
        prompts, embeds = sc._workload("encdec")
        pmodel = params_from_numpy(pcfg, jax.tree.map(np.asarray, jdense_p), "cpu")
        # the replay scores with the reference's helpers: after its prune,
        # whose compiles it shares
        jmasks, jrep = jprune.result()
        with pytest.MonkeyPatch.context() as mp:
            reference_search_costs(mp)
            pruned = pruning.prune_model(pmodel, pcfg, rng=np.random.default_rng(0),
                                         ocp_iters=ITERS[0], icp_iters=ITERS[1], workers=2)
        return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, x=x, runs=runs.result(),
                    isolated=isolated.result(), prompts=prompts, embeds=embeds,
                    prune=(pcfg, pmodel, pruned, jmasks, jrep))


def test_encode_and_forward_match(setup):
    cfg, model, x, ref = setup["cfg"], setup["model"], setup["x"], setup["runs"]
    frames = torch.from_numpy(x["frames"])
    _close(ref["encode"], encdec.encode(model, cfg, frames))
    _close(ref["forward"], zoo.forward(model, cfg, torch.from_numpy(x["forward"]),
                                       embeds=frames))
    with pytest.raises(ValueError, match="frame embeddings"):
        zoo.forward(model, cfg, torch.from_numpy(x["forward"]))


def _pool(setup):
    """The port's twin of the reference's pool: both prefills inserted."""
    cfg, model, x = setup["cfg"], setup["model"], setup["x"]
    pool = zoo.make_cache(cfg, N_SLOTS, MAX_SEQ, page=CASE["page"], n_pages=N_PAGES,
                          t_enc=T_ENC, device="cpu")
    lasts = []
    for frames, (row, slot, ids, bt_row) in zip(("frames", "short"), x["inserts"]):
        st = zoo.make_cache(cfg, 2, MAX_SEQ, t_enc=T_ENC, device="cpu")
        lasts.append(zoo.prefill(model, cfg, torch.from_numpy(x["tokens"]), st,
                                 embeds=torch.from_numpy(x[frames]),
                                 n_rows=torch.from_numpy(x["n_rows"])))
        zoo.paged_insert(cfg, pool, st, slot, row, torch.from_numpy(ids),
                         torch.from_numpy(bt_row), 2)
    return pool, torch.stack(lasts)


def test_prefill_and_paged_decode_match(setup):
    cfg, model, x, ref = setup["cfg"], setup["model"], setup["x"], setup["runs"]
    pool, lasts = _pool(setup)
    _close(ref["last"], lasts)
    # the per-slot leaves: 6 and 4 valid frames, the idle slot pristine
    _close(ref["pool_enc"]["enc_out"], pool["enc_out"])
    np.testing.assert_array_equal(pool["enc_len"].numpy(), ref["pool_enc"]["enc_len"])
    assert pool["enc_len"].tolist() == [4, 0, 6]
    assert not pool["enc_out"][0, 4:].any() and not pool["enc_out"][1].any()
    for step, tok in enumerate(x["decode"]):
        _close(ref["decode"][step], zoo.decode_step(model, cfg, torch.from_numpy(tok), pool))


def test_verify_and_rollback_match(setup):
    cfg, model, x, ref = setup["cfg"], setup["model"], setup["x"], setup["runs"]
    pool, _ = _pool(setup)
    for tok in x["decode"]:
        zoo.decode_step(model, cfg, torch.from_numpy(tok), pool)
    pos0 = zoo.cache_position(cfg, pool)
    logits, undo = zoo.verify_step(model, cfg, torch.from_numpy(x["verify"]), pool)
    _close(ref["verify"], logits)
    zoo.cache_rollback(cfg, pool, undo, pos0, torch.from_numpy(x["keep"]), 4)
    np.testing.assert_array_equal(zoo.cache_position(cfg, pool).numpy(),
                                  pos0.numpy() + x["keep"])
    _close(ref["after"], zoo.decode_step(model, cfg, torch.from_numpy(x["decode"][0]), pool))
    np.testing.assert_array_equal(pool["self"]["pos"].numpy(), ref["pos"])
    np.testing.assert_array_equal(pool["self"]["kpos"].numpy(), ref["kpos"])


def test_slot_row_helpers_match_reference():
    rng = np.random.default_rng(5)
    dst = rng.standard_normal((3, 6, 4)).astype(np.float32)
    src = rng.standard_normal((2, 4, 4)).astype(np.float32)
    want = np.asarray(jpaging.copy_slot_row(jnp.asarray(dst), jnp.asarray(src), 2, 1, 0))
    got = paging.copy_slot_row(torch.from_numpy(dst.copy()), torch.from_numpy(src), 2, 1, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jpaging.reset_slot_row(jnp.asarray(dst), 1, 0))
    np.testing.assert_array_equal(paging.reset_slot_row(torch.from_numpy(dst.copy()), 1, 0)
                                  .numpy(), want)


def test_serving_cross_attention_rows_do_not_depend_on_the_call():
    """`encdec._attend_fixed` (the serving path's cross-attention): a query
    row's output is bitwise the same alone and among other rows (what
    keeps a verify's rows its decode steps'), and within 1e-5 of
    `_attn_chunked` over the valid rows."""
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(6)
    q = torch.randn((3, 8, 4, 16), generator=g)
    k, v = torch.randn((3, 12, 2, 16), generator=g), torch.randn((3, 12, 2, 16), generator=g)
    enc_len = torch.tensor([12, 5, 9])
    valid = torch.arange(12)[None, :] < enc_len[:, None]
    full = encdec._attend_fixed(q, k, v, valid)
    for n in (1, 4):
        for at in (0, n):
            assert torch.equal(encdec._attend_fixed(q[:, at: at + n], k, v, valid),
                               full[:, at: at + n])
    kp = torch.where(valid, 0, paging.KPOS_SENTINEL).to(torch.int32)
    want = layers._attn_chunked(q, k, v, torch.zeros((3, 8), dtype=torch.int32), kp, True, 0)
    _close(want, full, 1e-5)


def _serve(setup, layout, spec=None):
    kw = dict(page=CASE["page"]) if layout == "paged" else dict(page=None)
    sched = Scheduler(setup["cfg"], setup["model"], max_slots=4, max_seq=MAX_SEQ,
                      decode_chunk=4, spec=spec, cache_kw=CASE["cache_kw"], device="cpu",
                      flightrec=True, **kw)
    reqs = [Request(rid=i, prompt=p, params=SamplingParams(max_new_tokens=CASE["max_new"]),
                    embeds=setup["embeds"][i], arrival=i)
            for i, p in enumerate(setup["prompts"])]
    sched.run(reqs)
    return [r.tokens for r in reqs], sched


@pytest.mark.parametrize("layout", ["paged", "stripe"])
def test_scheduler_gives_isolated_tokens(setup, layout):
    got, sched = _serve(setup, layout)
    assert got == setup["isolated"]
    assert sched.kv.paged == (layout == "paged")
    # no prefix sharing for this family; each slot's frames sit in its pool
    assert sched.prefix is None
    assert all(e.data["embeds"] for e in sched.flight.events if e.kind == "submit")
    if layout == "paged":
        assert sched.kv.n_free_pages == sched.kv.n_alloc_pages


@pytest.mark.parametrize("layout", ["paged", "stripe"])
def test_ngram_spec_streams_equal_plain(setup, layout):
    got, sched = _serve(setup, layout, SpecConfig(k=3))
    assert got == setup["isolated"]
    assert sched.stats.verify_steps > 0


def test_serve_engine_generate_with_frames(setup):
    prompts = np.stack([p[:5] for p in setup["prompts"]])
    frames = np.stack(setup["embeds"])
    eng = ServeEngine(setup["cfg"], setup["model"], max_seq=MAX_SEQ, page=CASE["page"],
                      device="cpu")
    got, stats = eng.generate(prompts, max_new_tokens=4, embeds=frames)
    # the engine's pool keeps enc_out at its default width, max_seq
    assert eng._sched.kv.cache["enc_out"].shape[1] == MAX_SEQ
    assert got.tolist() == [_isolated(setup, p, e, 4, MAX_SEQ)
                            for p, e in zip(prompts, frames)]
    assert stats.prefill_rows == 15    # decoder rows only; frames go to the encoder


def _isolated(setup, prompt, frames, n, t_enc):
    """The port's twin of `serve_conformance.greedy_isolated`: a batch-1
    prefill, then a greedy token loop."""
    cfg, model = setup["cfg"], setup["model"]
    cache = zoo.make_cache(cfg, 1, MAX_SEQ, t_enc=t_enc, device="cpu")
    last = zoo.prefill(model, cfg, torch.from_numpy(prompt[None]), cache,
                       embeds=torch.from_numpy(frames[None]))
    toks = [int(zoo.logits_fn(model, cfg, last)[0, : cfg.vocab].argmax())]
    while len(toks) < n:
        lg = zoo.decode_step(model, cfg, torch.tensor([[toks[-1]]], dtype=torch.int32), cache)
        toks.append(int(lg[0, : cfg.vocab].argmax()))
    return toks


def test_submit_refuses_frames_over_t_enc(setup):
    sched = Scheduler(setup["cfg"], setup["model"], max_slots=2, max_seq=MAX_SEQ,
                      page=CASE["page"], cache_kw=CASE["cache_kw"], device="cpu")
    frames = np.zeros((T_ENC + 1, setup["cfg"].d_model), np.float32)
    with pytest.raises(ValueError, match="t_enc"):
        sched.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32), embeds=frames))


def test_model_drafter_refuses_encdec(setup):
    with pytest.raises(ValueError, match="no embeds frontend"):
        ModelDrafter(setup["cfg"], setup["model"])


def test_compile_model_graph_containers_match_reference():
    _, cfg = _prune_cfgs()
    cfg = dataclasses.replace(cfg, n_kv_heads=4, n_enc_layers=2)
    jcfg, _ = _prune_cfgs()
    got, want = compile_model_graph(cfg), jcompile_model_graph(jcfg)
    assert [(c.key, c.tag) for c in got.containers] == [(c.key, c.tag) for c in want.containers]
    for c, jc in zip(got.containers, want.containers):
        c.graph.validate()
        assert c.graph.order == jc.graph.order
        assert ({(e.src, e.dst, e.kind) for e in c.graph.edges}
                == {(e.src, e.dst, e.kind) for e in jc.graph.edges})
    assert {n.path for _, n in got.instances()} >= {"xattn/wq", "xattn/wo", "mlp/wd"}
    unknown = dataclasses.replace(cfg, family="no_such_family")
    with pytest.raises(KeyError, match="unknown family"):
        compile_model_graph(unknown)


def test_prune_model_masks_match_reference(setup):
    pcfg, _, (permuted, masks, packed, rep), jmasks, jrep = setup["prune"]
    want = masks_from_numpy(pcfg, jmasks, "cpu")
    assert set(masks) == set(want) == {"enc", "dec"}
    for key in ("enc", "dec"):
        assert len(masks[key]) == 2
        for i, (got, ref) in enumerate(zip(masks[key], want[key])):
            assert set(got) == set(ref)
            for path, m in got.items():
                assert torch.equal(m, ref[path]), (key, i, path)
    assert [k for k, _ in rep.per_layer] == [k for k, _ in jrep.per_layer]
    _close([r for _, r in jrep.per_layer], [r for _, r in rep.per_layer], 1e-5)
    assert isinstance(packed.dec[1].xattn.wv.w, PackedHiNM)
    assert isinstance(packed.enc[0].mlp.wd.w, PackedHiNM)


def test_packed_forward_equals_masked_forward(setup):
    pcfg, pmodel, (permuted, masks, packed, _), _, _ = setup["prune"]
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, pcfg.vocab, (2, 16)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal((2, 8, pcfg.d_model)).astype(np.float32))
    y0 = zoo.forward(pmodel, pcfg, toks, embeds=frames)
    _close(y0, zoo.forward(permuted, pcfg, toks, embeds=frames))
    dense = zoo.forward(pruning.apply_masks(permuted, masks), pcfg, toks, embeds=frames)
    _close(dense, zoo.forward(packed, pcfg, toks, embeds=frames))
    # the mask tree walks both stacks, and back
    tree = pruning.mask_tree(zoo.params_of(pcfg, permuted), masks)
    assert tree["dec"]["xattn"]["wq"]["w"].shape == (2, 64, 64)
    assert tree["dec"]["ln_x"]["scale"] is None
    back = pruning.per_block(tree, list(masks["dec"][0]), key="dec")
    assert all(torch.equal(back[i][k], masks["dec"][i][k]) for i in range(2)
               for k in masks["dec"][i])
