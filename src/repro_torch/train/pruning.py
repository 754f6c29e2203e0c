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
import torch

from repro_torch import tree as T
from repro_torch.models import module as nn
from repro_torch.perm import ModelPermEngine, PermCache
from repro_torch.perm.engine import PruneReport

__all__ = ["PruneReport", "prune_model", "apply_masks", "mask_tree", "per_block",
           "get_node"]


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
    `path`, aligned with `permuted` (an encoder-decoder's masks are
    ``{"enc": [...], "dec": [...]}``, a recurrent family's ``{"stack0":
    [...], "stack1": [...]}``, one such list a stack); a second
    copy whose planned projections hold their `PackedHiNM` (rows in OCP
    order, `vec_idx` in ICP order), ready to serve through ``hinm_spmm``;
    and the `PruneReport`.

    `fisher` (second-order saliency) is one {path: stored-orientation
    Fisher diagonal} dict per block.  `cache` (a PermCache) skips searches
    whose saliency matrices hash to a previously solved instance.
    `workers` caps the search thread pool (default REPRO_PERM_WORKERS or
    cpu count; 1 = serial).

    `permute_params=False` runs the same search but returns ``(model,
    masks, None, report)``: the model untouched and masks in its ORIGINAL
    layout (tiles become non-contiguous row sets — irrelevant for
    masked-dense training, and it keeps optimizer moments aligned when the
    masks are refreshed mid-training).  Packing for serving needs the
    physical layout (`True`, the default).
    """
    engine = ModelPermEngine(
        cfg, method=method, rng=rng or np.random.default_rng(0),
        fisher=fisher, saliency_kind=saliency_kind,
        ocp_iters=ocp_iters, icp_iters=icp_iters,
        cache=cache, workers=workers,
    )
    if not permute_params:
        return model, engine.run_virtual(model), None, engine.report

    permuted = copy.deepcopy(model)
    stacked = {ci: (list(getattr(permuted, c.key)), fisher)
               for ci, c in enumerate(engine.graph.containers)}
    results = engine.run_stacks(stacked)

    packed = copy.deepcopy(permuted)
    masks = {}
    for ci, c in enumerate(engine.graph.containers):
        masks[c.key], packs = results[ci]
        for blk, layer_packs in zip(getattr(packed, c.key), packs):
            for path, p in layer_packs.items():
                nn.get_path(blk, path).set_weight(p)
    return permuted, _unstack(masks), packed, engine.report


def _by_stack(masks) -> dict:
    """Per-layer masks keyed by the layer stack they belong to: a
    decoder-only model's list is its ``blocks``' (the inverse of
    `_unstack`)."""
    return masks if isinstance(masks, dict) else {"blocks": masks}


def _unstack(masks: dict):
    """`_by_stack`'s inverse: a lone ``blocks`` stack's list as it is."""
    return masks["blocks"] if list(masks) == ["blocks"] else masks


def apply_masks(model, masks):
    """A copy of `model` with each masked projection's weight multiplied by
    its mask (masked-dense training and the packed model's dense twin)."""
    out = copy.deepcopy(model)
    for key, per_layer in _by_stack(masks).items():
        for blk, layer_masks in zip(getattr(out, key), per_layer):
            for path, m in layer_masks.items():
                lin = nn.get_path(blk, path)
                lin.set_weight(lin.w * m.to(lin.w.dtype))
    return out


def stack_of(tree: dict, key: str):
    """Layer stack `key` of a params-shaped tree: ``tree[key]``, and for a
    per-pattern-position stack ``stack{j}`` the reference's
    ``tree["stacks"][j]``."""
    if key not in tree and key.startswith("stack") and key[5:].isdigit():
        return tree["stacks"][int(key[5:])]
    return tree[key]


def get_node(tree: dict, key: str, path: str) -> dict:
    """The dict of a planned projection (``{"w": ..., "b": ...}``) in a
    params-shaped tree: stack `key` (`stack_of`) then `path`'s parts."""
    node = stack_of(tree, key)
    for part in path.split("/"):
        node = node[part]
    return node


def mask_tree(params: dict, masks) -> dict:
    """Per-block masks (``masks[i][path]``, as `prune_model` returns them)
    as the training state's mask tree: each projection's masks stacked
    over layers at its weight's place in `params`, ``None`` elsewhere."""
    tree = T.map(lambda _: None, params)
    for key, per_layer in _by_stack(masks).items():
        for path in per_layer[0]:
            get_node(tree, key, path)["w"] = torch.stack([m[path] for m in per_layer])
    return tree


def per_block(tree: dict, paths, key: str = "blocks") -> list[dict]:
    """The inverse view: ``[{path: leaf[i]}]`` per layer of stack `key` for
    the planned `paths` of a params-shaped tree (a Fisher diagonal for
    `prune_model`, a mask tree for `apply_masks`)."""
    stacks = {p: get_node(tree, key, p)["w"] for p in paths}
    n = len(next(iter(stacks.values())))
    return [{p: s[i] for p, s in stacks.items()} for i in range(n)]
