"""Port parity: the vlm family (phi-3-vision-4.2b and deit-base: the
transformer backbone with frontend-stub embeddings placed before the
tokens) against `repro`, and the new configs.

Models: each config at `reduced(frontend_tokens=8)` (2 layers, d_model
128, f32), the reference's init (seed 0) carried across by
`convert.params_from_numpy`; inputs from `tests/test_models.py`'s
`tiny_batch` (numpy seed 0: 32 tokens and 8 patch rows a lane).

- The three new configs equal the reference's field for field.
- The eval forward with embeds, and a bucketed prefill (8 patch rows
  before prompts of 20 / 32 tokens) followed by 2 decode steps, agree
  within 1e-4, the tolerance `tests/test_torch_model.py` holds the dense
  family to (sum-order differences only).
- `prune_model` with noperm gives the reference's masks, and its packed
  forward the reference's packed forward within 1e-4; with gyro 2/2
  (phi-3) it gives the reference's masks when the search scores with the
  reference's own cost helpers (`reference_search_costs`).
- A `Scheduler` run of six greedy requests, four with patch rows of two
  shapes (8 and 4 rows) and two of tokens only, over two slots, gives the
  reference `Scheduler`'s streams on the same packed weights; the two
  shapes prefill in groups of their own.  `submit` refuses a request
  whose rows (patch rows included) exceed max_seq; the flight record's
  `submit` marks embeds, and `replay` refuses such a record.

The reference's compiles run on threads beside the port's work.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import base as jbase
from repro.models import zoo as jzoo
from repro.train import pruning as jpruning
from repro_torch import serve
from repro_torch.configs import base
from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.core.types import PackedHiNM
from repro_torch.models import zoo
from repro_torch.serve import Request, SamplingParams, Scheduler, ServeEngine
from repro_torch.serve.flightrec import requests_from_record
from repro_torch.train import pruning
from test_models import tiny_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_train_ref import reference_search_costs

NAMES = ("phi_3_vision_4_2b", "deit_base")
NEW = NAMES + ("seamless_m4t_medium",)
TOL = 1e-4
P = 8
MAX_SEQ = 64
ITERS = (2, 2)
SCHED = dict(max_slots=2, max_seq=MAX_SEQ, page=16, decode_chunk=4)

j_init = jax.jit(jzoo.init, static_argnums=1)
j_pack = jax.jit(jzoo.pack_params, static_argnums=0)
j_forward = jax.jit(jzoo.forward, static_argnums=1)
j_prefill = jax.jit(jzoo.prefill, static_argnums=1)
j_decode = jax.jit(jzoo.decode_step, static_argnums=1)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                               rtol=tol, atol=tol)


def _fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["dtype"] = np.dtype(out["dtype"]).name if not isinstance(
        out["dtype"], torch.dtype) else str(out["dtype"]).split(".")[-1]
    out["hinm"] = dataclasses.asdict(out["hinm"])
    return out


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(name, reduced):
    jcfg, cfg = jbase.load_arch(name), base.load_arch(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    assert _fields(cfg) == _fields(jcfg)


def _inputs(jcfg):
    """tiny_batch's tokens and patch rows, a bucketed prefill of them (20 /
    32 prompt tokens after the 8 patch rows) and two decode steps."""
    batch = jax.tree.map(np.array, tiny_batch(jcfg))
    toks = batch["tokens"].copy()
    toks[0, 20:] = 0
    rng = np.random.default_rng(1)
    return dict(tokens=batch["tokens"], embeds=batch["embeds"], prefill=toks,
                n_rows=np.array([P + 20, P + 32], np.int32),
                decode=rng.integers(0, jcfg.vocab, (2, 2, 1)).astype(np.int32))


def _workload(mod, vocab, d):
    """Six greedy requests, one arriving a step: patch rows of 8, none, 4,
    8, none, 4, prompts of 5-10 tokens, 6 new each."""
    rng = np.random.default_rng(29)
    reqs = []
    for i, p in enumerate((P, 0, 4, P, 0, 4)):
        emb = rng.standard_normal((p, d)).astype(np.float32) if p else None
        reqs.append(mod.Request(rid=i, prompt=rng.integers(1, vocab, (5 + i,)).astype(np.int32),
                                params=mod.SamplingParams(max_new_tokens=6), embeds=emb,
                                arrival=i))
    return reqs


def _reference_runs(jcfg, params, x):
    """The forward, prefill + decode and noperm prune of one config."""
    out = {"forward": j_forward(params, jcfg, jnp.asarray(x["tokens"]),
                                embeds=jnp.asarray(x["embeds"]))}
    st = jzoo.make_cache(jcfg, 2, MAX_SEQ)
    out["last"], st = j_prefill(params, jcfg, jnp.asarray(x["prefill"]), st,
                                embeds=jnp.asarray(x["embeds"]), n_rows=jnp.asarray(x["n_rows"]))
    logits = []
    for tok in x["decode"]:
        lg, st = j_decode(params, jcfg, jnp.asarray(tok), st)
        logits.append(lg)
    out["decode"], out["pos"] = np.stack(logits), st["pos"]
    _, out["noperm"], packed_np, _ = jpruning.prune_model(params, jcfg, method="noperm",
                                                          workers=4)
    out["noperm_forward"] = j_forward(packed_np, jcfg, jnp.asarray(x["tokens"]),
                                      embeds=jnp.asarray(x["embeds"]))
    return out


def _reference_gyro(jcfg, params):
    return {"gyro": jpruning.prune_model(params, jcfg, ocp_iters=ITERS[0],
                                         icp_iters=ITERS[1], workers=8)[1]}


def _reference_serve(jcfg, params):
    packed = j_pack(jcfg, params)
    sched = jserve.Scheduler(jcfg, packed, **SCHED)
    reqs = _workload(jserve, jcfg.vocab, jcfg.d_model)
    sched.run(reqs)
    return {"packed": packed, "streams": [r.tokens for r in reqs]}


@pytest.fixture(scope="module")
def reference():
    """Each config's reference side (init at seed 0, then on threads: the
    forward, prefill + decode and noperm prune; phi-3's gyro prune and its
    scheduler run on the reference's packing), as numpy."""
    cfgs = {n: jbase.load_arch(n).reduced(frontend_tokens=P) for n in NAMES}
    params = {n: j_init(jax.random.PRNGKey(0), c) for n, c in cfgs.items()}
    xs = {n: _inputs(c) for n, c in cfgs.items()}
    phi = NAMES[0]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        jobs = [(phi, ex.submit(_reference_gyro, cfgs[phi], params[phi])),
                (phi, ex.submit(_reference_serve, cfgs[phi], params[phi]))]
        jobs += [(n, ex.submit(_reference_runs, cfgs[n], params[n], xs[n])) for n in NAMES]
        out = {n: {"params": params[n]} for n in NAMES}
        for n, job in jobs:
            out[n].update(job.result())
    return {n: (jax.tree.map(np.asarray, out[n]), xs[n]) for n in NAMES}


@pytest.fixture(scope="module", params=NAMES)
def case(request, reference):
    ref, x = reference[request.param]
    cfg = base.load_arch(request.param).reduced(frontend_tokens=P)
    return request.param, cfg, ref, x, params_from_numpy(cfg, ref["params"], "cpu")


def test_forward_with_embeds_matches(case):
    _, cfg, ref, x, model = case
    got = zoo.forward(model, cfg, torch.from_numpy(x["tokens"]),
                      embeds=torch.from_numpy(x["embeds"]))
    assert got.shape == (2, P + 32, cfg.d_model)
    _close(ref["forward"], got)


def test_prefill_with_embeds_and_decode_match(case):
    _, cfg, ref, x, model = case
    st = zoo.make_cache(cfg, 2, MAX_SEQ, device="cpu")
    last = zoo.prefill(model, cfg, torch.from_numpy(x["prefill"]), st,
                       embeds=torch.from_numpy(x["embeds"]), n_rows=torch.from_numpy(x["n_rows"]))
    _close(ref["last"], last)
    for step, tok in enumerate(x["decode"]):
        _close(ref["decode"][step], zoo.decode_step(model, cfg, torch.from_numpy(tok), st))
    # decode resumed at each lane's patch rows + prompt
    np.testing.assert_array_equal(st["pos"].numpy(), ref["pos"])
    assert st["pos"][0].tolist() == [P + 22, P + 34]


def _masks_equal(got, want_tree, cfg):
    want = masks_from_numpy(cfg, want_tree, "cpu")
    assert len(got) == len(want) == cfg.n_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for path, m in g.items():
            assert torch.equal(m, w[path]), (i, path)


def test_noperm_prune_matches(case):
    name, cfg, ref, x, model = case
    permuted, masks, packed, _ = pruning.prune_model(model, cfg, method="noperm", workers=2)
    _masks_equal(masks, ref["noperm"], cfg)
    assert isinstance(packed.blocks[0].mlp.wd.w, PackedHiNM)
    got = zoo.forward(packed, cfg, torch.from_numpy(x["tokens"]),
                      embeds=torch.from_numpy(x["embeds"]))
    _close(ref["noperm_forward"], got)
    dense = zoo.forward(pruning.apply_masks(permuted, masks), cfg,
                        torch.from_numpy(x["tokens"]), embeds=torch.from_numpy(x["embeds"]))
    _close(dense, got)


def test_gyro_prune_masks_match_on_reference_costs(reference):
    ref, _ = reference[NAMES[0]]
    cfg = base.load_arch(NAMES[0]).reduced(frontend_tokens=P)
    model = params_from_numpy(cfg, ref["params"], "cpu")
    with pytest.MonkeyPatch.context() as mp:
        reference_search_costs(mp)
        _, masks, packed, rep = pruning.prune_model(
            model, cfg, rng=np.random.default_rng(0), ocp_iters=ITERS[0],
            icp_iters=ITERS[1], workers=2)
    _masks_equal(masks, ref["gyro"], cfg)
    assert 0.0 < rep.mean_retained < 1.0


@pytest.fixture(scope="module")
def served(reference):
    ref, _ = reference[NAMES[0]]
    cfg = base.load_arch(NAMES[0]).reduced(frontend_tokens=P)
    sched = Scheduler(cfg, params_from_numpy(cfg, ref["packed"], "cpu"), device="cpu",
                      flightrec=True, **SCHED)
    reqs = _workload(serve, cfg.vocab, cfg.d_model)
    sched.run(reqs)
    return cfg, ref, sched, reqs


def test_scheduler_streams_equal_reference(served):
    _, ref, sched, reqs = served
    assert [r.tokens for r in reqs] == [list(s) for s in ref["streams"]]
    assert all(r.finish_reason == "length" for r in reqs)


def test_embeds_shapes_prefill_in_groups_of_their_own(served):
    cfg, _, sched, reqs = served
    shapes = {None if r.embeds is None else r.embeds.shape for r in reqs}
    assert {k[2] for k in sched._prefill_io} == shapes == {None, (P, cfg.d_model),
                                                            (4, cfg.d_model)}
    by_rid = {r.rid: r for r in reqs}
    for ev in sched.flight.events:
        if ev.kind == "admit":
            assert len({None if by_rid[i].embeds is None else by_rid[i].embeds.shape
                        for i in ev.data["group"]}) == 1
    # patch rows count as decoder rows: prefill rows and pages
    assert sched.stats.prefill_rows >= sum(len(r.prompt) for r in reqs) + 2 * P + 2 * 4


def test_flight_record_marks_embeds_and_replay_refuses(served):
    _, _, sched, reqs = served
    subs = [ev for ev in sched.flight.events if ev.kind == "submit"]
    assert [ev.data["embeds"] for ev in subs] == [r.embeds is not None for r in reqs]
    with pytest.raises(ValueError, match="embeds requests cannot be rebuilt"):
        requests_from_record(sched.flight.events)


def test_submit_refuses_too_many_rows(served):
    cfg, ref, _, _ = served
    sched = Scheduler(cfg, params_from_numpy(cfg, ref["packed"], "cpu"), device="cpu",
                      **SCHED)
    big = np.zeros((MAX_SEQ - 8, cfg.d_model), np.float32)
    req = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                  params=SamplingParams(max_new_tokens=4), embeds=big)
    with pytest.raises(ValueError, match="prompt rows"):
        sched.submit(req)
    req.embeds = big[:-2]
    sched.submit(req)    # 54 patch rows + 5 tokens + 4 new fit in 64


def test_serve_engine_generate_with_embeds(served):
    cfg, ref, sched, reqs = served
    # the first and fourth requests again (8 patch rows), as one batch of
    # equal-length prompts
    prompts = np.stack([reqs[0].prompt, reqs[3].prompt[:5]])
    embeds = np.stack([reqs[0].embeds, reqs[3].embeds])
    eng = ServeEngine(cfg, params_from_numpy(cfg, ref["packed"], "cpu"), max_seq=MAX_SEQ,
                      page=16, device="cpu")
    got, stats = eng.generate(prompts, max_new_tokens=6, embeds=embeds)
    assert got[0].tolist() == reqs[0].tokens
    assert stats.prefill_rows == 2 * (P + 5)
