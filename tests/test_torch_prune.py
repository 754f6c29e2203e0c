"""Port parity: the pruning front end (`repro_torch.core.{gyro, baselines,
hungarian, saliency, api}`, `repro_torch.perm`, `repro_torch.train.pruning`)
against `repro` on the same numpy inputs, on the CPU.

- The jitted cost helpers agree within 1e-6 relative (sum order only).
- At the quickstart shape (256 x 512, V 32, 2:4, 50%) `ocp`, `icp`,
  `gyro_permute` and `prune_matrix` return the reference's permutations,
  masks and packed fields exactly.
- On reduced qwen2-0.5b, `prune_model` folds the same output permutations
  into the same weights, keeps the same columns per tile, and realizing
  the reference's search results in the port is bit-equal to the
  reference's masks and packed fields.  The ICP orders themselves may
  differ where the Hungarian assignment has tied optima: the two
  frameworks' f32 costs differ in the last bit, and the solver then picks
  a different, equally good assignment (ROADMAP Queue 3);
  `test_icp_assignment_ties_are_cost_equal` pins that such a step is a tie.
  Replayed on the reference's own ICP cost matrices, the port's search
  makes the reference's decisions and its outputs are bit-equal, but for
  an exact tie at an ICP accept test (Queue 3), where the retained
  saliency agrees within 1e-5 relative.
- The reference's pruned, packed model, carried across, serves the
  reference scheduler's greedy token streams.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.core import baselines as jbase
from repro.core import gyro as jgyro
from repro.core import hungarian as jhung
from repro.core import saliency as jsal
from repro.core import sparsity as jsp
from repro.core.types import HiNMConfig as JHiNMConfig
from repro.models import zoo as jzoo
from repro.perm import realize as jrealize
from repro.train import pruning as jpruning
from repro_torch import serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import masks_from_numpy, params_from_numpy, to_tensor
from repro_torch.core import api, baselines, gyro, hungarian, saliency, sparsity
from repro_torch.core.packing import pack_mask
from repro_torch.core.types import HiNMConfig, PackedHiNM
from repro_torch.models import module as M
from repro_torch.models import zoo
from repro_torch.perm import PermCache, realize
from repro_torch.perm.engine import ModelPermEngine, default_workers, validate_out_perm
from repro_torch.train import pruning

REL = 1e-6
CFG, JCFG = HiNMConfig(v=32), JHiNMConfig(v=32)
PATHS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wg", "mlp/wu", "mlp/wd")


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The search runs thousands of tiny CPU ops from several threads;
    intra-op threads only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers and single matrices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart():
    """examples/quickstart.py's weight and the reference's gyro result."""
    rng = np.random.default_rng(0)
    n_out, n_in = 256, 512
    row = np.exp(rng.normal(scale=0.6, size=(n_out, 1)))
    col = np.exp(rng.normal(scale=0.6, size=(1, n_in)))
    w = (rng.normal(size=(n_out, n_in)) * row * col).astype(np.float32)
    sal = np.abs(w)
    ref = jgyro.gyro_permute(sal, JCFG, ocp_iters=12, icp_iters=10,
                             rng=np.random.default_rng(1))
    return w, sal, ref


def test_cost_helpers_match(quickstart):
    _, sal, _ = quickstart
    rng = np.random.default_rng(2)
    tiles = sal[rng.permutation(256)[:96]].reshape(3, 32, 512)
    for mode in ("hinm", "vector"):
        _close(gyro._tile_retained(torch.tensor(tiles), CFG, mode),
               jgyro._tile_retained(jnp.asarray(tiles), JCFG, mode))
    groups = rng.random((5, 16, 32, 4)).astype(np.float32)
    _close(gyro._nm_retained_groups(torch.tensor(groups), 2),
           jgyro._nm_retained_groups(jnp.asarray(groups), 2, 4))
    _close(gyro._channel_pruned_saliency(torch.tensor(sal), CFG),
           jgyro._channel_pruned_saliency(jnp.asarray(sal), JCFG))
    tile = sal[:32, :256]
    _close(gyro._icp_marginals(torch.tensor(tile), 2, 4),
           jgyro._icp_marginals(jnp.asarray(tile), 2, 4))
    rem, cols = rng.random((100, 32, 3)).astype(np.float32), rng.random((100, 32)).astype(np.float32)
    _close(gyro._icp_cost_matrix(torch.tensor(rem), torch.tensor(cols), 2, 4),
           jgyro._icp_cost_matrix(jnp.asarray(rem), jnp.asarray(cols), 2, 4))
    assert gyro._sample_schedule(32, 8) == jgyro._sample_schedule(32, 8)


def test_sparsity_saliency_and_hungarian_match(quickstart):
    w, sal, _ = quickstart
    t = torch.tensor(sal)
    _close(sparsity.retained_saliency(t, CFG), jsp.retained_saliency(jnp.asarray(sal), JCFG))
    np.testing.assert_array_equal(sparsity.unstructured_mask(t, 0.75),
                                  jsp.unstructured_mask(jnp.asarray(sal), 0.75))
    mask = sparsity.hinm_mask(t, CFG)
    np.testing.assert_array_equal(sparsity.apply_mask(torch.tensor(w), mask),
                                  jsp.apply_mask(jnp.asarray(w), jnp.asarray(mask.numpy())))
    fisher = np.random.default_rng(3).random(w.shape).astype(np.float32)
    np.testing.assert_array_equal(
        saliency.saliency_for(torch.tensor(w), "second_order", torch.tensor(fisher)),
        np.asarray(jsal.saliency_for(jnp.asarray(w), "second_order", jnp.asarray(fisher))))
    with pytest.raises(ValueError, match="fisher"):
        saliency.saliency_for(torch.tensor(w), "second_order")
    grads = [{"w": torch.tensor(w[:4])}, {"w": torch.tensor(2 * w[:4])}]
    fd = saliency.fisher_diag(lambda g: g, grads)
    np.testing.assert_allclose(fd["w"], 2.5 * w[:4] ** 2, rtol=1e-6)
    pts = sal[:64, :40].astype(np.float64)
    np.testing.assert_array_equal(
        hungarian.balanced_kmeans(pts, 8, np.random.default_rng(4)),
        jhung.balanced_kmeans(pts, 8, np.random.default_rng(4)))
    cost = np.random.default_rng(5).random((30, 30))
    np.testing.assert_array_equal(hungarian.linear_sum_assignment(cost)[1],
                                  jhung.linear_sum_assignment(cost)[1])


def test_ocp_icp_gyro_match_at_quickstart_shape(quickstart):
    w, sal, ref = quickstart
    perm, hist = gyro.ocp(sal, CFG, iters=12, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(perm, ref.out_perm)
    _close(hist, ref.history[:-1])
    sal_p = sal[ref.out_perm]
    col_ids = np.asarray(jsp.kept_column_ids(jnp.asarray(sal_p), JCFG))
    gathered = np.take_along_axis(sal_p.reshape(8, 32, 512), col_ids[:, None, :], axis=2)
    orders, _ = gyro.icp(gathered, CFG, iters=10)
    np.testing.assert_array_equal(np.take_along_axis(col_ids, orders, axis=1), ref.col_order)
    got = gyro.gyro_permute(torch.tensor(sal), CFG, ocp_iters=12, icp_iters=10,
                            rng=np.random.default_rng(1))
    np.testing.assert_array_equal(got.out_perm, ref.out_perm)
    np.testing.assert_array_equal(got.col_order, ref.col_order)
    _close([got.retained, got.total, got.retained_fraction],
           [ref.retained, ref.total, ref.retained_fraction])


def test_realize_and_prune_matrix_match(quickstart):
    w, sal, ref = quickstart
    want = jrealize.realize_matrix(jnp.asarray(w), ref.out_perm, ref.col_order, JCFG, sal=sal)
    got = realize.realize_matrix(torch.tensor(w), ref.out_perm, ref.col_order, CFG, sal=sal)
    np.testing.assert_array_equal(got.w_p, want.w_p)
    np.testing.assert_array_equal(got.mask_p, want.mask_p)
    for f in ("vals", "vec_idx", "nm_idx"):
        np.testing.assert_array_equal(getattr(got.packed, f), getattr(want.packed, f))
    _close(got.retained, want.retained)
    # prune_matrix draws the generator as gyro_permute does: same search
    pm = api.prune_matrix(torch.tensor(w), CFG, rng=np.random.default_rng(1),
                          ocp_iters=12, icp_iters=10)
    np.testing.assert_array_equal(pm.out_perm, ref.out_perm)
    np.testing.assert_array_equal(pm.packed.vec_idx, ref.col_order)
    np.testing.assert_array_equal(
        pm.mask, jrealize.mask_to_original_rows(want.mask_p, ref.out_perm))
    np.testing.assert_array_equal(api.masked_dense(torch.tensor(w), pm), w * pm.mask.numpy())
    _close(pm.retained_fraction, ref.retained_fraction)


def test_baselines_match(quickstart):
    _, sal, _ = quickstart
    sub = sal[:64, :128]
    np.testing.assert_array_equal(baselines.ovw_ocp(sub, CFG, np.random.default_rng(6)),
                                  jbase.ovw_ocp(sub, JCFG, np.random.default_rng(6)))
    _close(baselines.ovw_prune(sub, 32, 0.75, np.random.default_rng(9)),
           jbase.ovw_prune(sub, 32, 0.75, np.random.default_rng(9)))
    _close(baselines.unstructured_retained(sal, 0.75), jbase.unstructured_retained(sal, 0.75))
    tile = sub[:32, :64]
    np.testing.assert_array_equal(
        baselines.apex_icp_tile(tile, CFG, np.random.default_rng(7), max_swaps=300),
        jbase.apex_icp_tile(tile, JCFG, np.random.default_rng(7), max_swaps=300))
    got = baselines.hinm_v1(tile, CFG, np.random.default_rng(8), icp_iters=3)
    want = jbase.hinm_v1(tile, JCFG, np.random.default_rng(8), icp_iters=3)
    np.testing.assert_array_equal(got.col_order, want.col_order)
    _close(got.retained, want.retained)
    # v2 = our OCP + 2000 Apex swaps per tile: each part is compared above;
    # here the port alone (the swaps only ever raise the retained saliency)
    v2 = baselines.hinm_v2(sub, CFG, np.random.default_rng(8), ocp_iters=3)
    ids = np.asarray(sparsity.kept_column_ids(torch.tensor(sub[v2.out_perm]), CFG))
    np.testing.assert_array_equal(np.sort(v2.col_order, 1), ids)
    noperm = gyro.gyro_permute(sub[v2.out_perm], CFG, run_ocp=False, run_icp=False)
    assert v2.retained >= noperm.retained


# ---------------------------------------------------------------------------
# the whole model: reduced qwen2-0.5b
# ---------------------------------------------------------------------------


def _reference_icp_costs(rem, cols, n, m, chunk=64):
    """The ICP cost matrix by the reference's own helper (XLA's f32 sums),
    so that the port's Hungarian step sees the reference's costs."""
    return torch.from_numpy(np.array(jgyro._icp_cost_matrix(
        jnp.asarray(rem.numpy()), jnp.asarray(cols.numpy()), n, m, chunk)))


# the results do not depend on the worker count; at these sizes more
# search threads only contend for the GIL and the cores
SEARCH_WORKERS = 2


@pytest.fixture(scope="module")
def pruned():
    """The reference's prune_model outputs and the port's, from the same
    initial weights (defaults: gyro, 8/8 iterations, seed 0).  `ref`
    holds the reference's (permuted, masks, packed) as numpy trees;
    `replay` the port's outputs with its ICP costs taken from the
    reference's helper."""
    jcfg = jload_arch("qwen2_0_5b").reduced()
    cfg = load_arch("qwen2_0_5b").reduced()
    params = jax.tree.map(np.asarray, jax.jit(jzoo.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    jout = jpruning.prune_model(params, jcfg, rng=np.random.default_rng(0),
                                workers=SEARCH_WORKERS)
    model = params_from_numpy(cfg, params, "cpu")
    perm, masks, packed, rep = pruning.prune_model(model, cfg, rng=np.random.default_rng(0),
                                                   workers=SEARCH_WORKERS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gyro, "_icp_cost_matrix", _reference_icp_costs)
        replay = pruning.prune_model(model, cfg, rng=np.random.default_rng(0),
                                     workers=SEARCH_WORKERS)
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, params=params, jpacked=jout[2], jrep=jout[3],
        ref=[jax.tree.map(np.asarray, t) for t in jout[:3]], model=model,
        perm=perm, masks=masks, packed=packed, rep=rep, replay=replay)


def _ref_leaf(tree, i, path):
    grp, name = path.split("/")
    return tree["blocks"][grp][name]


def test_prune_model_folds_the_same_permutations(pruned):
    r = pruned
    jperm, _, jpacked = r.ref
    assert set(r.rep.out_perms) == {f"blocks[{i}]/{p}" for i in range(r.cfg.n_layers)
                                    for p in PATHS}
    for i, blk in enumerate(r.perm.blocks):
        for path in PATHS:
            lin, ref = M.get_path(blk, path), _ref_leaf(jperm, i, path)
            np.testing.assert_array_equal(lin.w.numpy(), ref["w"][i])
            if lin.b is not None:
                np.testing.assert_array_equal(lin.b.numpy(), ref["b"][i])
            # the ICP may order the kept columns differently (tied Hungarian
            # optima); which columns each tile keeps is the same
            got, want = M.get_path(r.packed.blocks[i], path).w, _ref_leaf(jpacked, i, path)["w"]
            np.testing.assert_array_equal(np.sort(got.vec_idx.numpy(), 1),
                                          np.sort(want.vec_idx[i], 1))
            # the model handed in is left as it was
            np.testing.assert_array_equal(M.get_path(r.model.blocks[i], path).w.numpy(),
                                          _ref_leaf(r.params, i, path)["w"][i])
    assert [t for t, _ in r.rep.per_layer] == [t for t, _ in r.jrep.per_layer]
    # the tied assignments move the mean by 4.5e-5; an ICP without its
    # Hungarian step reads 4.0e-2, one on the transposed cost 2.5e-2
    # (ROADMAP Queue 3)
    _close(r.rep.mean_retained, r.jrep.mean_retained, rel=1e-4)


# where the accept test at gyro.py:295 (reference :261) meets an exact tie
# that the two f32 sums break apart (ROADMAP Queue 3)
ACCEPT_TIES = {"blocks[0]/mlp/wg"}


def test_prune_model_on_the_reference_icp_costs_is_bit_equal(pruned):
    """The port's search replayed on the reference's ICP cost matrices:
    folded weights, masks and packed fields equal the reference's bit for
    bit.  Only a projection with an accept-test tie may keep its columns
    in another order; its retained saliency, as every projection's and
    the model's mean, agrees within 1e-5 relative."""
    cfg, (jperm, jmasks, jpacked) = pruned.cfg, pruned.ref
    perm, masks, packed, rep = pruned.replay
    differ = set()
    for i in range(cfg.n_layers):
        for path in PATHS:
            np.testing.assert_array_equal(M.get_path(perm.blocks[i], path).w.numpy(),
                                          _ref_leaf(jperm, i, path)["w"][i])
            p, jp = M.get_path(packed.blocks[i], path).w, _ref_leaf(jpacked, i, path)["w"]
            if not np.array_equal(p.vec_idx.numpy(), jp.vec_idx[i]):
                differ.add(f"blocks[{i}]/{path}")
                np.testing.assert_array_equal(np.sort(p.vec_idx.numpy(), 1),
                                              np.sort(jp.vec_idx[i], 1))
                continue
            np.testing.assert_array_equal(masks[i][path].numpy(),
                                          _ref_leaf(jmasks, i, path)["w"][i])
            np.testing.assert_array_equal(p.vals.numpy(), jp.vals[i])
            np.testing.assert_array_equal(p.nm_idx.numpy(), jp.nm_idx[i])
    assert differ <= ACCEPT_TIES
    assert [t for t, _ in rep.per_layer] == [t for t, _ in pruned.jrep.per_layer]
    _close([r for _, r in rep.per_layer], [r for _, r in pruned.jrep.per_layer], rel=1e-5)
    _close(rep.mean_retained, pruned.jrep.mean_retained, rel=1e-5)


def test_realizing_the_reference_search_is_bit_equal(pruned):
    """Phase 3 on the reference's permuted weights and its vec_idx (its ICP
    orders): masks and packed fields equal the reference's bit for bit, and
    `masks_from_numpy` carries the masks across unchanged."""
    cfg = pruned.cfg
    jperm, jmasks, jpacked = pruned.ref
    carried = masks_from_numpy(cfg, jmasks, "cpu")
    for i in range(cfg.n_layers):
        for path in PATHS:
            w = to_tensor(_ref_leaf(jperm, i, path)["w"][i], "cpu")
            jp = _ref_leaf(jpacked, i, path)["w"]
            _, mask, p, _ = realize.realize_stored(w, np.arange(w.shape[1]), jp.vec_idx[i],
                                                   cfg.hinm)
            np.testing.assert_array_equal(mask.numpy(), _ref_leaf(jmasks, i, path)["w"][i])
            np.testing.assert_array_equal(carried[i][path].numpy(), mask.numpy())
            for f in ("vals", "vec_idx", "nm_idx"):
                np.testing.assert_array_equal(getattr(p, f).numpy(), getattr(jp, f)[i])


def test_port_outputs_are_consistent(pruned):
    """The port's own result: folding keeps the function, the packed model
    equals its masked-dense twin, masks are the packs' supports at 75%
    sparsity, and equal ICP orders give bit-equal masks and packs."""
    cfg, model, perm, masks, packed = (pruned.cfg, pruned.model, pruned.perm,
                                       pruned.masks, pruned.packed)
    _, jmasks, jpacked = pruned.ref
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)))
    y0 = zoo.forward(model, cfg, toks)
    _close(zoo.forward(perm, cfg, toks), y0, rel=1e-4)
    dense = zoo.forward(pruning.apply_masks(perm, masks), cfg, toks)
    _close(zoo.forward(packed, cfg, toks), dense, rel=1e-4)
    n_equal = 0
    for i, blk in enumerate(packed.blocks):
        for path in PATHS:
            p = M.get_path(blk, path).w
            assert isinstance(p, PackedHiNM)
            np.testing.assert_array_equal(pack_mask(p).T.numpy(), masks[i][path].numpy())
            assert float(masks[i][path].float().mean()) == 0.25
            jp = _ref_leaf(jpacked, i, path)["w"]
            if np.array_equal(p.vec_idx.numpy(), jp.vec_idx[i]):
                n_equal += 1
                np.testing.assert_array_equal(masks[i][path].numpy(),
                                              _ref_leaf(jmasks, i, path)["w"][i])
                np.testing.assert_array_equal(p.vals.numpy(), jp.vals[i])
                np.testing.assert_array_equal(p.nm_idx.numpy(), jp.nm_idx[i])
    assert n_equal >= 1


def test_icp_assignment_ties_are_cost_equal(pruned):
    """Where the port's ICP diverges from the reference's (ROADMAP Queue 3:
    reduced qwen2-0.5b, layer 0 `attn/wk`, tile 2, step 3), both
    assignments cost the same under the reference's own cost matrix."""
    sal = np.abs(pruned.params["blocks"]["attn"]["wk"]["w"][0].T).astype(np.float32)
    jc = JHiNMConfig(v=8)
    col_ids = np.asarray(jsp.kept_column_ids(jnp.asarray(sal), jc))
    tile = np.take_along_axis(sal.reshape(8, 8, -1), col_ids[:, None, :], axis=2)[2]
    order, g, n_diverged = np.arange(tile.shape[1]), tile.shape[1] // 4, 0
    for _ in range(8):
        marg = np.asarray(jgyro._icp_marginals(jnp.asarray(tile[:, order]), 2, 4))
        np.testing.assert_array_equal(
            gyro._icp_marginals(torch.tensor(tile[:, order]), 2, 4).numpy().argmin(1),
            marg.argmin(1))
        slot = marg.argmin(1)
        pos = order.reshape(g, 4)
        ext = np.take_along_axis(pos, slot[:, None], 1)[:, 0]
        keep = np.ones((g, 4), bool)
        np.put_along_axis(keep, slot[:, None], False, 1)
        rem_pos = pos[keep].reshape(g, 3)
        rem = np.moveaxis(tile[:, rem_pos.reshape(-1)].reshape(8, g, 3), 0, 1)
        cols = tile[:, ext].T
        want = np.asarray(jgyro._icp_cost_matrix(jnp.asarray(rem), jnp.asarray(cols), 2, 4))
        got = gyro._icp_cost_matrix(torch.tensor(rem), torch.tensor(cols), 2, 4).numpy()
        _close(got, want)
        a_ref = jhung.linear_sum_assignment(want)[1]
        a_port = hungarian.linear_sum_assignment(got)[1]
        rows = np.arange(g)
        np.testing.assert_allclose(want[rows, a_port].astype(np.float64).sum(),
                                   want[rows, a_ref].astype(np.float64).sum(), rtol=1e-6)
        n_diverged += not np.array_equal(a_ref, a_port)
        order = np.concatenate([rem_pos, ext[a_ref][:, None]], 1).reshape(-1)
    assert n_diverged >= 1


def test_engine_rules_cache_and_workers(pruned, monkeypatch):
    cfg, model = pruned.cfg, pruned.model
    with pytest.raises(ValueError, match="unknown method"):
        ModelPermEngine(cfg, method="magic")
    with pytest.raises(NotImplementedError, match="training slice"):
        pruning.prune_model(model, cfg, permute_params=False)
    monkeypatch.setenv("REPRO_PERM_WORKERS", "two")
    with pytest.raises(ValueError, match="REPRO_PERM_WORKERS"):
        default_workers()
    monkeypatch.setenv("REPRO_PERM_WORKERS", "3")
    assert default_workers() == 3
    cache = PermCache()
    outs = [pruning.prune_model(model, cfg, method="icp_only", icp_iters=2, cache=cache,
                                workers=w) for w in (1, 4)]
    assert outs[0][3].searches_run == 7 * cfg.n_layers and outs[1][3].cache_hits == 7 * cfg.n_layers
    for a, b in zip(outs[0][2].blocks, outs[1][2].blocks):
        for path in PATHS:
            np.testing.assert_array_equal(M.get_path(a, path).w.vec_idx,
                                          M.get_path(b, path).w.vec_idx)
    graph = zoo.perm_graph(cfg).containers[0].graph
    assert graph.nodes["mlp/wu"].tied_to == "mlp/wg"
    assert graph.nodes["attn/wv"].row_blocks == cfg.n_kv_heads
    # the validator behind every fold: residual rows and a tied partner
    # stay put, wv's rows move within its kv-head blocks
    for what, perm in pruned.rep.out_perms.items():
        validate_out_perm(graph.nodes[what.split("/", 1)[1]], graph, perm, what)
    for path in ("attn/wq", "mlp/wu"):
        n = M.get_path(model.blocks[0], path).w.shape[1]
        with pytest.raises(ValueError, match="identity"):
            validate_out_perm(graph.nodes[path], graph, _swapped(n, 0, 1), path)
    n_v = M.get_path(model.blocks[0], "attn/wv").w.shape[1]
    validate_out_perm(graph.nodes["attn/wv"], graph, _swapped(n_v, 0, 1), "attn/wv")
    with pytest.raises(ValueError, match="block"):
        validate_out_perm(graph.nodes["attn/wv"], graph, _swapped(n_v, 0, n_v - 1), "attn/wv")


def _swapped(n, a, b):
    p = np.arange(n)
    p[[a, b]] = p[[b, a]]
    return p


# ---------------------------------------------------------------------------
# serving the pruned model
# ---------------------------------------------------------------------------

SCHED = dict(max_slots=2, max_seq=64, page=16, decode_chunk=4)


def test_reference_pruned_model_serves_the_same_streams(pruned):
    jcfg, cfg, jpacked_tree = pruned.jcfg, pruned.cfg, pruned.jpacked
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in (5, 16, 8, 13)]

    def requests(mod):
        return [mod.Request(rid=i, prompt=p, arrival=i,
                            params=mod.SamplingParams(max_new_tokens=6))
                for i, p in enumerate(prompts)]

    want = requests(jserve)
    jserve.Scheduler(jcfg, jpacked_tree, prefix_share=False, async_admission=False,
                     **SCHED).run(want)
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jpacked_tree), "cpu")
    assert isinstance(model.blocks[0].mlp.wd.w, PackedHiNM)
    got = requests(serve)
    serve.Scheduler(cfg, model, prefix_share=False, async_admission=False, device="cpu",
                    **SCHED).run(got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(r.n_generated == 6 for r in got)
