"""Port parity: gradual HiNM pruning (`repro_torch.train.gradual`) and the
mask-only search it refreshes with (`ModelPermEngine.run_virtual`,
`prune_model(permute_params=False)`), against `repro` on the CPU at
`tests/test_train.py`'s reduced qwen2-0.5b, whose pruned projections have
`tests/test_perm_graph.py`'s shapes.

- `GradualSchedule` gives the reference's values; `recompute_masks` the
  reference's masks, bit for bit.
- The mask-only search returns the reference's masks under ROADMAP Queue
  3's tie rule (equal, or the mean retained saliency within 1e-4 relative
  and a replay on the reference's ICP costs equal), leaves the model as
  it was, gives masks with the HiNM structure under its own searched row
  permutations, and a shared `PermCache` skips repeated searches.
- A short `make_mask_schedule` run (vector ramp, the N:M switch with the
  gyro refresh, refreshes after it, the frozen layout) gives the
  reference's masks at every event, the refreshes under the tie rule.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.train import gradual as jgradual
from repro.train import pruning as jpruning
from repro_torch import tree as T
from repro_torch.core.types import HiNMConfig
from repro_torch.perm import ModelPermEngine, PermCache
from repro_torch.train import gradual, pruning
from torch_train_ref import (ITERS, PATHS, assert_tie_rule, inputs, masks_differ,
                             port_model, port_params, reference)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


# the reference's recompute_masks jitted (its config arguments static), as
# tests/test_train.py runs the reference; the schedule test hands it to the
# reference's make_mask_schedule, which calls it through its module
j_recompute = jax.jit(jgradual.recompute_masks, static_argnums=(1, 2, 3))


RECOMPUTE = [(0.0, False), (0.3, False), (0.5, False), (0.5, True)]


def _jhcfg(sparsity):
    return inputs().jcfg.hinm.__class__(v=8, n=2, m=4, vector_sparsity=sparsity)


@pytest.fixture(scope="module")
def setup():
    """The shared reference results (`torch_train_ref.reference`); the
    reference's `recompute_masks` compiles for this module's
    configurations (the schedule's ramp at step 2 too) on threads
    meanwhile."""
    r0 = inputs()
    ramp = _sched(jgradual, r0.jcfg.hinm).config_at(2)
    with ThreadPoolExecutor(4) as ex:
        futs = [ex.submit(j_recompute, r0.params, r0.jcfg, h, nm_on)
                for h, nm_on in [(_jhcfg(sp), nm) for sp, nm in RECOMPUTE] + [(ramp, False)]]
        r = reference()
        for f in futs:
            f.result()
    return r


def _tree_equal(got, want):
    g, w = T.leaves_with_names(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert [n for n, _ in g] == ["/".join(str(k) for k in p) for p, _ in w]
    for (name, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _sched(mod, target):
    return mod.GradualSchedule(target=target, vector_end_step=4, nm_step=6, update_every=2,
                               refresh_perm_every=4)


def test_schedule_values_match(setup):
    want, got = _sched(jgradual, setup.jcfg.hinm), _sched(gradual, setup.cfg.hinm)
    for step in range(0, 16):
        assert got.vector_sparsity(step) == want.vector_sparsity(step)
        assert got.nm_active(step) == want.nm_active(step)
        w, g = want.config_at(step), got.config_at(step)
        assert (g.v, g.n, g.m, g.vector_sparsity) == (w.v, w.n, w.m, w.vector_sparsity)


@pytest.mark.parametrize("sparsity,nm_on", RECOMPUTE)
def test_recompute_masks_match(setup, sparsity, nm_on):
    r = setup
    h = HiNMConfig(v=8, n=2, m=4, vector_sparsity=sparsity)
    want = j_recompute(r.params, r.jcfg, _jhcfg(sparsity), nm_on)
    got = gradual.recompute_masks(port_params(r), r.cfg, h, nm_on)
    _tree_equal(got, want)
    dens = float(np.mean([m.float().mean() for m in T.leaves(got)]))
    assert abs(dens - (1 - sparsity) * (0.5 if nm_on else 1.0)) < 0.02


def test_virtual_prune_matches_reference(setup):
    """`prune_model(permute_params=False)` and `run_virtual` on the
    reference's weights: the reference's masks (tie rule), the model
    untouched, the HiNM structure under each searched permutation."""
    r = setup
    model = port_model(r)
    before = [t.clone() for t in model.buffers()]
    kw = dict(ocp_iters=ITERS[0], icp_iters=ITERS[1], workers=1)
    out, masks, packed, rep = pruning.prune_model(model, r.cfg, permute_params=False, **kw)
    assert out is model and packed is None
    assert all(torch.equal(a, b) for a, b in zip(model.buffers(), before))
    assert [t for t, _ in rep.per_layer] == [t for t, _ in r.vrep.per_layer]
    assert rep.searches_run == r.vrep.searches_run == len(PATHS)
    assert_tie_rule(masks, r.vmasks, r.params, lambda: pruning.prune_model(
        port_model(r), r.cfg, permute_params=False, **kw)[1])
    np.testing.assert_allclose(rep.mean_retained, r.vrep.mean_retained, rtol=1e-4)
    # the engine's own entry point, same generator: the same masks
    again = ModelPermEngine(r.cfg, rng=np.random.default_rng(0), **kw).run_virtual(model)
    assert all(torch.equal(a[p], b[p]) for a, b in zip(again, masks) for p in PATHS)
    # HiNM structure under the searched rows: per tile at most K columns
    # survive, and every row keeps N of each M-group of them
    hcfg = r.cfg.hinm
    assert len(rep.out_perms) == r.cfg.n_layers * len(PATHS)
    for tag, perm in rep.out_perms.items():
        i, path = int(tag[len("blocks["):tag.index("]")]), tag.split("/", 1)[1]
        m = masks[i][path].T[torch.as_tensor(perm)]           # (n_out, n_in), searched rows
        k = hcfg.kept_columns(m.shape[1])
        tiles = m.reshape(-1, hcfg.v, m.shape[1])
        assert int(tiles.any(dim=1).sum(dim=1).max()) <= k
        assert bool((m.sum(dim=1) == k * hcfg.n // hcfg.m).all())


def _as_numpy_tree(tree):
    return T.map(lambda t: t.numpy(), tree)


def test_virtual_prune_cache_and_workers(setup):
    r = setup
    model, cache = port_model(r), PermCache()
    kw = dict(ocp_iters=ITERS[0], icp_iters=ITERS[1], permute_params=False, cache=cache)
    _, m1, _, rep1 = pruning.prune_model(model, r.cfg, workers=1, **kw)
    assert rep1.searches_run > 0 and rep1.cache_hits == 0
    _, m2, _, rep2 = pruning.prune_model(model, r.cfg, workers=4,
                                         rng=np.random.default_rng(123), **kw)
    assert rep2.searches_run == 0 and rep2.cache_hits == r.cfg.n_layers * len(PATHS)
    assert not masks_differ(m2, _as_numpy_tree(pruning.mask_tree(port_params(r), m1)))


def test_mask_schedule_matches_reference(setup, monkeypatch):
    """Steps 0-12 of a schedule (ramp to 4, N:M and the gyro refresh at 6,
    refreshes every 4 after it, masks every 2) over the same weights: the
    same events, the reference's masks at each; the repeated refreshes
    hit the schedule's PermCache.  The refreshes search at ITERS, as the
    other search tests do (chip_smoke's train phase runs the schedule's
    own 8/8 at full width)."""
    r = setup
    monkeypatch.setattr(jgradual, "recompute_masks", j_recompute)
    for mod in (jpruning, pruning):
        monkeypatch.setattr(mod, "prune_model", functools.partial(
            mod.prune_model, ocp_iters=ITERS[0], icp_iters=ITERS[1]))
    jcb = jgradual.make_mask_schedule(r.jcfg, _sched(jgradual, r.jcfg.hinm), method="gyro")
    cb = gradual.make_mask_schedule(r.cfg, _sched(gradual, r.cfg.hinm), method="gyro")

    class State:
        pass

    js, ts = State(), State()
    js.params, ts.params = r.params, port_params(r)
    events = []
    for step in range(13):
        want, got = jcb(step, js), cb(step, ts)
        assert (got is None) == (want is None), step
        if got is None:
            continue
        events.append(step)
        want = jax.tree.map(np.asarray, want)
        if step < 6:
            _tree_equal(got, want)
            continue
        blocks = pruning.per_block(got, PATHS)
        if step == 6:
            # the gyro refresh (generator seeded with the step), under the
            # tie rule
            assert_tie_rule(blocks, want, r.params, lambda: pruning.prune_model(
                port_model(r), r.cfg, rng=np.random.default_rng(6), permute_params=False)[1])
            first, jfirst = blocks, want
        else:   # later refreshes over the same weights: cache hits, the same masks
            assert all(torch.equal(a[p], b[p]) for a, b in zip(blocks, first) for p in PATHS)
            _tree_equal(T.map(lambda a: torch.from_numpy(np.array(a)), want), jfirst)
    assert events == [2, 4, 6, 8, 12]
    assert [e["step"] for e in cb.refreshes] == [6, 8, 12]
    n_items = r.cfg.n_layers * len(PATHS)
    assert cb.refreshes[0]["report"].searches_run == n_items
    assert all(e["report"].searches_run == 0 and e["report"].cache_hits == n_items
               for e in cb.refreshes[1:])
    assert cb.perm_cache.hits == 2 * n_items and all(e["wall_s"] > 0 for e in cb.refreshes)
