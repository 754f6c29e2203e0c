"""Reference results shared by the training parity tests
(`test_torch_train.py`, `test_torch_gradual.py`): computed once per
process, since the reference's first `prune_model` call spends most of
its time compiling."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gyro as jgyro
from repro.core.types import HiNMConfig as jHiNMConfig
from repro.configs.base import load_arch as jload_arch
from repro.data.pipeline import SyntheticLMData as JSyntheticLMData
from repro.models import zoo as jzoo
from repro.train import pruning as jpruning
from repro_torch.configs.base import load_arch
from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.models import zoo
from repro_torch.train import pruning

# tests/test_train.py's reduced qwen2-0.5b; its pruned projections have the
# shapes of tests/test_perm_graph.py's CFG
SIZES = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
             head_dim=16)
# a cheap search: (ocp_iters, icp_iters)
ITERS = (2, 2)
# the reference's search threads: its generators are spawned per item up
# front, so the masks are the same for any count, and its first call's
# compiles run side by side
REF_WORKERS = 7
PATHS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wg", "mlp/wu", "mlp/wd")


@functools.lru_cache(maxsize=None)
def inputs():
    """The reference's init (seed 0) and five batches of its
    SyntheticLMData (seed 1, 4 x 32), as numpy."""
    jcfg = jload_arch("qwen2_0_5b").reduced(**SIZES)
    params = jax.tree.map(np.asarray, jax.jit(jzoo.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    data = JSyntheticLMData(jcfg.vocab, 32, 4, seed=1)
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=load_arch("qwen2_0_5b").reduced(**SIZES), params=params,
        batches=[data.batch(i) for i in range(5)])


@functools.lru_cache(maxsize=None)
def reference():
    """`inputs()` and the reference's mask-only `prune_model` (gyro at
    ITERS) on them: its masks as numpy and its report."""
    r = inputs()
    _, vmasks, _, vrep = jpruning.prune_model(r.params, r.jcfg, ocp_iters=ITERS[0],
                                              icp_iters=ITERS[1], workers=REF_WORKERS,
                                              permute_params=False)
    return types.SimpleNamespace(**vars(r), vmasks=jax.tree.map(np.asarray, vmasks),
                                 vrep=vrep)


@functools.lru_cache(maxsize=None)
def ones_masks():
    """The reference's mask tree with every mask all ones (the unmasked
    step, traced as the masked one is): the port's `recompute_masks` at
    no sparsity, whose tree is the reference's."""
    from repro_torch import tree as T
    from repro_torch.core.types import HiNMConfig
    from repro_torch.train import gradual

    r = inputs()
    masks = gradual.recompute_masks(port_params(r), r.cfg,
                                    HiNMConfig(v=r.cfg.hinm.v, vector_sparsity=0.0), False)
    return T.map(lambda t: t.numpy(), masks)


def port_model(r):
    return params_from_numpy(r.cfg, r.params, "cpu")


def port_params(r):
    return zoo.params_of(r.cfg, port_model(r))


def port_masks(r, params, masks=None):
    """The reference's mask tree as the port's (stacked, None elsewhere)."""
    return pruning.mask_tree(params, masks_from_numpy(
        r.cfg, r.vmasks if masks is None else masks, "cpu"))


def tbatch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def masks_differ(got: list[dict], want_tree) -> set:
    """The (layer, path)s where the port's per-block masks differ from the
    reference's mask tree."""
    differ = set()
    for i, layer in enumerate(got):
        for path, m in layer.items():
            grp, name = path.split("/")
            if not np.array_equal(m.numpy(), want_tree["blocks"][grp][name]["w"][i]):
                differ.add((i, path))
    return differ


def reference_icp_costs(rem, cols, n, m, chunk=64):
    """The ICP cost matrix by the reference's own helper (XLA's f32 sums),
    so that the port's Hungarian step sees the reference's costs."""
    return torch.from_numpy(np.array(jgyro._icp_cost_matrix(
        jnp.asarray(rem.numpy()), jnp.asarray(cols.numpy()), n, m, chunk)))


def _jhinm(cfg):
    return jHiNMConfig(v=cfg.v, n=cfg.n, m=cfg.m, vector_sparsity=cfg.vector_sparsity)


def reference_search_costs(mp):
    """Make the port's gyro search score with the reference's own jitted
    helpers (XLA's f32 sums): OCP's tile totals, its Hungarian rows (one
    base tile at a time, as the reference evaluates them) and its channel
    misfits, and ICP's cost matrices.  `ocp` sums what `_tile_retained`
    returns into its accept test's total, so the patch returns the
    reference's total whole, in the first place of a zero vector."""
    from repro_torch.core import gyro

    def tile_total(tiles, cfg, cost_mode):
        ret = jgyro._tile_retained(jnp.asarray(tiles.numpy()), _jhinm(cfg), cost_mode)
        out = torch.zeros(tiles.shape[0], dtype=torch.float32)
        out[0] = float(ret.sum())
        return out

    def assignment_retained(base, clus, cfg, cost_mode):
        p, clus_j = base.shape[0], jnp.asarray(clus.numpy())
        return np.stack([np.asarray(jgyro._tile_retained(
            jnp.concatenate([jnp.broadcast_to(jnp.asarray(base[i].numpy())[None],
                                              (p,) + tuple(base.shape[1:])), clus_j], axis=1),
            _jhinm(cfg), cost_mode)) for i in range(p)])

    def misfit(sal_perm, cfg):
        return torch.from_numpy(np.array(jgyro._channel_pruned_saliency(
            jnp.asarray(sal_perm.numpy()), _jhinm(cfg))))

    mp.setattr(gyro, "_tile_retained", tile_total)
    mp.setattr(gyro, "_assignment_retained", assignment_retained)
    mp.setattr(gyro, "_channel_pruned_saliency", misfit)
    mp.setattr(gyro, "_icp_cost_matrix", reference_icp_costs)


def mean_retained(masks: list[dict], params: dict) -> float:
    """The magnitude saliency a set of per-block masks keeps, averaged as
    `PruneReport.mean_retained` averages it (per projection over layers,
    then over projections); a row permutation does not change it."""
    per_path = []
    for path in masks[0]:
        grp, name = path.split("/")
        w = np.abs(params["blocks"][grp][name]["w"]).astype(np.float64)
        per_path.append(np.mean([(w[i] * m[path].numpy()).sum() / w[i].sum()
                                 for i, m in enumerate(masks)]))
    return float(np.mean(per_path))


def assert_tie_rule(masks, want_tree, params, rerun):
    """ROADMAP Queue 3's tie rule for a search's masks against the
    reference's: equal, or the mean retained saliency within 1e-4
    relative and `rerun()` — the port's search again, its ICP cost
    matrices taken from the reference's helper — giving the reference's
    masks, which pins the difference on an ICP assignment whose optima tie
    under the two frameworks' f32 costs."""
    from repro_torch.core import gyro

    if not masks_differ(masks, want_tree):
        return
    want = masks_from_numpy(reference().cfg, want_tree, "cpu")
    np.testing.assert_allclose(mean_retained(masks, params), mean_retained(want, params),
                               rtol=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gyro, "_icp_cost_matrix", reference_icp_costs)
        replay = rerun()
    assert not masks_differ(replay, want_tree)
