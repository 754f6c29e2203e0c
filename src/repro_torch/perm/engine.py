"""Search/propagate/realize orchestration over a ModelPermGraph (port of
`repro.perm.engine`).

Work items are (container, layer index, node): every layer of every
container contributes one search per node. Items are independent unless a
coupling edge links their nodes within the same layer, so the engine runs
a wavefront: all dependency-free items dispatch to a thread pool (each
search issues torch cost evaluations on the saliency's device and numpy /
scipy Hungarian solves, all of which release the GIL), and a completed
producer immediately unlocks its consumers after its perm is folded on the
main thread.

The reference vmaps over layer-stacked ``(L, ...)`` leaves; the port's
model is a list of `Block` modules, so the engine loops over blocks and
folds permutations into their `Linear`s in place.

Determinism: every item gets its own RNG derived from the base generator in
canonical item order, so results are independent of worker count and
completion order. One caveat: with a shared PermCache AND workers > 1,
items whose saliency matrices are byte-identical race to fill the same
cache slot, and which (equally valid) result wins depends on completion
order. `workers=1` (or REPRO_PERM_WORKERS=1) forces the fully serial path.
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np
import torch

from repro_torch.models import module as nn
from repro_torch.perm import propagate, realize
from repro_torch.perm.cache import PermCache
from repro_torch.perm.graph import (
    Container,
    EdgeKind,
    ModelPermGraph,
    PermNode,
    compile_model_graph,
)
from repro_torch.perm.search import METHODS, search_projection


@dataclasses.dataclass
class PruneReport:
    per_layer: list[tuple[str, float]] = dataclasses.field(default_factory=list)
    searches_run: int = 0
    cache_hits: int = 0
    # "blocks[i]/path" -> the out_perm its search returned (validated)
    out_perms: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # path -> host seconds of its search items, summed over layers
    item_seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    # "search" / "realize" -> wall seconds of the phase
    phase_seconds: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def mean_retained(self) -> float:
        if not self.per_layer:
            return 1.0
        return float(np.mean([r for _, r in self.per_layer]))


def default_workers() -> int:
    env = os.environ.get("REPRO_PERM_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            raise ValueError(
                f"REPRO_PERM_WORKERS must be an integer, got {env!r}"
            ) from None
    return max(1, min(8, os.cpu_count() or 1))


def _saliency(wt: torch.Tensor, fisher_t, saliency_kind: str) -> torch.Tensor:
    if saliency_kind == "second_order" and fisher_t is not None:
        return (wt.to(torch.float32) ** 2) * fisher_t
    return wt.abs().to(torch.float32)


def _spawn_rngs(rng: np.random.Generator, n: int) -> list[np.random.Generator]:
    """Deterministic child generators; independent of completion order."""
    seeds = rng.integers(0, 2**63 - 1, size=n, dtype=np.uint64)
    return [np.random.default_rng(int(s)) for s in seeds]


def validate_out_perm(node: PermNode, cgraph, perm, what: str) -> None:
    """Raise unless a physical search's out_perm keeps the node's
    constraints: a bijection; the identity for residual-constrained rows
    and for a tied partner (its rows follow the tie source); within row
    blocks for a block-diagonal node."""
    propagate.check_bijection(perm, what)
    if node.is_tied_partner:
        propagate.check_identity(perm, what)
    for c in cgraph.constraints(node.path):
        if c.kind == EdgeKind.RESIDUAL:
            propagate.check_identity(perm, what)
        elif c.kind == EdgeKind.BLOCK_DIAGONAL and not node.is_tied_partner:
            propagate.check_block_diagonal(perm, node.row_blocks, what)


@dataclasses.dataclass
class _LayerState:
    layer: torch.nn.Module         # the block, progressively folded in place
    fisher: dict | None            # path -> stored-orientation Fisher diagonal
    tag: str
    results: dict[str, tuple]      # path -> (out_perm, col_order)


@dataclasses.dataclass(frozen=True)
class _Item:
    ci: int                        # container index
    li: int                        # layer index within the container
    path: str


class ModelPermEngine:
    """Runs the three phases over a model's layers."""

    def __init__(
        self,
        cfg,
        *,
        method: str = "gyro",
        rng: np.random.Generator | None = None,
        fisher=None,
        saliency_kind: str = "magnitude",
        ocp_iters: int = 8,
        icp_iters: int = 8,
        cache: PermCache | None = None,
        workers: int | None = None,
        graph: ModelPermGraph | None = None,
    ):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        self.cfg = cfg
        self.hcfg = cfg.hinm
        self.method = method
        self.rng = rng or np.random.default_rng(0)
        self.fisher = fisher
        self.saliency_kind = saliency_kind
        self.ocp_iters = ocp_iters
        self.icp_iters = icp_iters
        self.cache = cache
        self.workers = default_workers() if workers is None else max(1, workers)
        self.graph = graph or compile_model_graph(cfg)
        self.report = PruneReport()

    # -- phase 1+2: search with inline propagation ---------------------------

    def _search_one(self, node: PermNode, w, tied_ws, fisher_leaf,
                    rng: np.random.Generator, virtual: bool):
        """One work item: the search of one stored (n_in, n_out) weight."""
        if node.is_tied_partner and not virtual:
            # rows already follow the tie source; identity OCP, own ICP
            can_rows, row_blocks = False, 1
        else:
            can_rows, row_blocks = node.can_permute_rows, node.row_blocks
        ft = None if fisher_leaf is None else fisher_leaf.T
        sal = _saliency(w.T, ft, self.saliency_kind)
        sal_rows = sal
        for tw in tied_ws:
            sal_rows = torch.cat([sal_rows, _saliency(tw.T, None, "magnitude")], dim=1)
        return search_projection(
            sal, sal_rows, self.hcfg, method=self.method,
            can_permute_rows=can_rows, row_blocks=row_blocks, rng=rng,
            ocp_iters=self.ocp_iters, icp_iters=self.icp_iters,
            cache=self.cache,
        )

    def _timed_search(self, node, w, *rest):
        """One search item, timed (host seconds)."""
        t0 = time.perf_counter()
        perm, col = self._search_one(node, w, *rest, virtual=False)
        return perm, col, time.perf_counter() - t0

    def _snapshot(self, state: _LayerState, cgraph, path: str):
        """Collect the (already folded) inputs of one search item."""
        node = cgraph.nodes[path]
        w = nn.get_path(state.layer, path).w
        tied_ws = [nn.get_path(state.layer, e.dst).w
                   for e in cgraph.out_edges(path) if e.kind == EdgeKind.TIED]
        fisher_leaf = None
        if state.fisher is not None and self.saliency_kind == "second_order":
            fisher_leaf = state.fisher[path]
        return node, w, tied_ws, fisher_leaf

    @staticmethod
    def _permute_rows(lin, perm) -> None:
        lin.set_weight(propagate.permute_out(lin.w, perm))
        if lin.b is not None:
            lin.b = propagate.permute_bias(lin.b, perm)

    def _fold(self, state: _LayerState, cgraph, path: str, perm):
        """Propagate a completed search along the node's out-edges."""
        if propagate.is_identity(perm):
            return
        self._permute_rows(nn.get_path(state.layer, path), perm)
        for e in cgraph.out_edges(path):
            dst = nn.get_path(state.layer, e.dst)
            if e.kind == EdgeKind.TIED:
                self._permute_rows(dst, perm)
            elif e.kind == EdgeKind.GQA_EXPAND:
                cperm = propagate.gqa_expand_perm(
                    perm, self.cfg.n_kv_heads, self.cfg.n_heads, self.cfg.head_dim
                )
                dst.set_weight(propagate.permute_in(dst.w, cperm))
            else:  # producer-rows → consumer-cols
                dst.set_weight(propagate.permute_in(dst.w, perm))

    def _run_items(self, states: dict[tuple[int, int], _LayerState],
                   containers: list[Container]):
        """Wavefront-schedule every (container, layer, node) search item."""
        items: list[_Item] = []
        deps: dict[_Item, set[_Item]] = {}
        dependents: dict[_Item, list[_Item]] = {}
        for (ci, li), state in states.items():
            cgraph = containers[ci].graph
            node_deps = cgraph.deps()
            for path in cgraph.topo_order():
                it = _Item(ci, li, path)
                items.append(it)
                dset = {_Item(ci, li, s) for s in node_deps[path]}
                deps[it] = dset
                for d in dset:
                    dependents.setdefault(d, []).append(it)
        rngs = dict(zip(items, _spawn_rngs(self.rng, len(items))))
        misses0 = self.cache.misses if self.cache else 0
        hits0 = self.cache.hits if self.cache else 0

        def task_args(it: _Item):
            state = states[(it.ci, it.li)]
            return self._snapshot(state, containers[it.ci].graph, it.path)

        def complete(it: _Item, perm, col_order, seconds):
            state = states[(it.ci, it.li)]
            cgraph = containers[it.ci].graph
            what = f"{state.tag}/{it.path}"
            validate_out_perm(cgraph.nodes[it.path], cgraph, perm, what)
            self._fold(state, cgraph, it.path, perm)
            state.results[it.path] = (perm, col_order)
            self.report.out_perms[what] = perm
            secs = self.report.item_seconds
            secs[it.path] = secs.get(it.path, 0.0) + seconds

        if self.workers <= 1:
            for it in items:
                complete(it, *self._timed_search(*task_args(it), rngs[it]))
        else:
            remaining = {it: set(d) for it, d in deps.items()}
            futures = {}
            with ThreadPoolExecutor(max_workers=self.workers) as ex:
                def submit(it: _Item):
                    futures[ex.submit(self._timed_search, *task_args(it), rngs[it])] = it

                for it in items:
                    if not remaining[it]:
                        submit(it)
                while futures:
                    done, _ = wait(futures, return_when=FIRST_COMPLETED)
                    for f in done:
                        it = futures.pop(f)
                        complete(it, *f.result())
                        for dep in dependents.get(it, ()):
                            remaining[dep].discard(it)
                            if not remaining[dep]:
                                submit(dep)

        if self.cache:
            self.report.cache_hits += self.cache.hits - hits0
            self.report.searches_run += self.cache.misses - misses0
        else:
            self.report.searches_run += len(items)

    # -- phase 3: realize ----------------------------------------------------

    def _realize_layer(self, state: _LayerState, cgraph):
        """Pack + mask every searched node of one folded layer. Returns
        ({path: stored-orientation mask}, {path: PackedHiNM})."""
        masks: dict[str, torch.Tensor] = {}
        packs: dict[str, object] = {}
        for path in cgraph.order:
            _, col_order = state.results[path]
            lin = nn.get_path(state.layer, path)
            identity = np.arange(lin.w.shape[1])
            _, masks[path], packs[path], retained = realize.realize_stored(
                lin.w, identity, col_order, self.hcfg)
            self.report.per_layer.append((f"{state.tag}/{path}", retained))
        return masks, packs

    # -- public entry points -------------------------------------------------

    def run_stacks(self, stacked_containers: dict[int, tuple]):
        """Physical pruning over {container_index: (blocks, fisher)}: `blocks`
        is a list of layer modules, folded in place; `fisher` None or one
        {path: stored-orientation Fisher diagonal} per layer.

        Returns {container_index: (masks, packs)}, each a list with one
        {path: tensor} dict per layer."""
        states: dict[tuple[int, int], _LayerState] = {}
        counts: dict[int, int] = {}
        for ci, (blocks, fstack) in stacked_containers.items():
            tag = self.graph.containers[ci].tag
            counts[ci] = len(blocks)
            for i, blk in enumerate(blocks):
                states[(ci, i)] = _LayerState(
                    layer=blk, fisher=None if fstack is None else fstack[i],
                    tag=f"{tag}[{i}]", results={})
        t0 = time.perf_counter()
        self._run_items(states, self.graph.containers)
        self.states = states  # searched perms, introspectable post-run
        t1 = time.perf_counter()

        out = {}
        for ci, n in counts.items():
            cgraph = self.graph.containers[ci].graph
            per_layer = [self._realize_layer(states[(ci, i)], cgraph) for i in range(n)]
            out[ci] = ([m for m, _ in per_layer], [p for _, p in per_layer])
        self.report.phase_seconds.update(search=t1 - t0, realize=time.perf_counter() - t1)
        return out

    def run_virtual(self, params):
        """Mask-only pruning in the original layout: used by gradual
        training only, so it is ported with the training slice."""
        raise NotImplementedError(
            "mask-only (virtual) pruning is ported with the training slice; "
            "see ROADMAP.md Queue 1 item 9")
