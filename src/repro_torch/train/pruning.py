"""Model-level HiNM pruning on the PermGraph engine (port of
`repro.train.pruning`).

The model's `hinm_plan` compiles into a permutation-propagation graph
(`repro_torch.perm`): prunable projections are nodes, the coupling rules
(GQA expansion, tied SwiGLU partners) are typed edges. Pruning runs in
three phases — search (gyro per node, thread-pool dispatched over
independent nodes across all layers, cost evaluations on the model's
device), propagate (fold every out-perm along its edges, with
bijection/identity/block validation), realize (pack + mask + report,
shared with `core.api.prune_matrix`).

Weights are stored (n_in, n_out); HiNM rows = stored columns, so the engine
transposes in and out of the core API. Returned masks align with the
RETURNED (permuted) model, not the original.
"""
from __future__ import annotations

import copy

import numpy as np

from repro_torch.models import module as nn
from repro_torch.perm import ModelPermEngine, PermCache
from repro_torch.perm.engine import PruneReport

__all__ = ["PruneReport", "prune_model", "apply_masks"]


def prune_model(
    model,
    cfg,
    method: str = "gyro",
    rng: np.random.Generator | None = None,
    fisher=None,
    saliency_kind: str = "magnitude",
    ocp_iters: int = 8,
    icp_iters: int = 8,
    permute_params: bool = True,
    cache: PermCache | None = None,
    workers: int | None = None,
):
    """Prune every planned projection of `model` (left untouched).

    Returns ``(permuted, masks, packed, report)``: a copy of the model with
    every permutation folded into its dense weights; ``masks[i][path]``,
    the stored-orientation (n_in, n_out) keep-mask of block i's projection
    `path`, aligned with `permuted`; a second copy whose planned
    projections hold their `PackedHiNM` (rows in OCP order, `vec_idx` in
    ICP order), ready to serve through ``hinm_spmm``; and the
    `PruneReport`.

    `fisher` (second-order saliency) is one {path: stored-orientation
    Fisher diagonal} dict per block.  `cache` (a PermCache) skips searches
    whose saliency matrices hash to a previously solved instance.
    `workers` caps the search thread pool (default REPRO_PERM_WORKERS or
    cpu count; 1 = serial).  `permute_params=False` (mask-only pruning in
    the original layout) serves gradual training and raises until the
    training slice ports it.
    """
    engine = ModelPermEngine(
        cfg, method=method, rng=rng or np.random.default_rng(0),
        fisher=fisher, saliency_kind=saliency_kind,
        ocp_iters=ocp_iters, icp_iters=icp_iters,
        cache=cache, workers=workers,
    )
    if not permute_params:
        engine.run_virtual(model)

    permuted = copy.deepcopy(model)
    stacked = {ci: (list(getattr(permuted, c.key)), fisher)
               for ci, c in enumerate(engine.graph.containers)}
    results = engine.run_stacks(stacked)

    packed = copy.deepcopy(permuted)
    masks = None
    for ci, c in enumerate(engine.graph.containers):
        masks, packs = results[ci]
        for blk, layer_packs in zip(getattr(packed, c.key), packs):
            for path, p in layer_packs.items():
                nn.get_path(blk, path).set_weight(p)
    return permuted, masks, packed, engine.report


def apply_masks(model, masks):
    """A copy of `model` with each masked projection's weight multiplied by
    its mask (masked-dense training and the packed model's dense twin)."""
    out = copy.deepcopy(model)
    for blk, layer_masks in zip(out.blocks, masks):
        for path, m in layer_masks.items():
            lin = nn.get_path(blk, path)
            lin.set_weight(lin.w * m.to(lin.w.dtype))
    return out
