"""Permutation-propagation graph: nodes, typed edges, plan compilation
(port of `repro.perm.graph`).

A `LayerPermGraph` is the per-layer-type template compiled from a list of
`PruneSpec`s. Nodes are prunable projections; edges carry the coupling
rules:

  producer-rows→consumer-cols : the producer's output-row permutation is
                                folded into the consumer's input columns
                                (free at runtime via the consumer's vec_idx)
  tied                        : elementwise-coupled rows (SwiGLU gate/up)
                                share the producer's OCP perm; the tied
                                partner then runs its own identity-OCP
                                search on the folded weight
  gqa-expand                  : the producer's within-kv-head row perm is
                                expanded to the per-query-head column perm
                                of the consumer (GQA V → attention output)
  residual-identity           : residual-constrained rows — OCP is pinned
                                to identity and validated after search
  block-diagonal              : OCP restricted to contiguous row blocks
                                (head-structured outputs); validated to
                                never cross a block boundary

The model-level `ModelPermGraph` holds one container per layer template
and where its layers live on the model.  The port has the decoder-only
plan (a list of specs over ``model.blocks``); the per-pattern-position
and encoder/decoder plans come with their families (ROADMAP Queue 1
item 8).
"""
from __future__ import annotations

import dataclasses


class EdgeKind:
    PRODUCER = "producer-rows→consumer-cols"
    TIED = "tied"
    GQA_EXPAND = "gqa-expand"
    RESIDUAL = "residual-identity"
    BLOCK_DIAGONAL = "block-diagonal"


# sentinel dst for constraint edges that do not couple two projections
RESIDUAL_SINK = "<residual>"


@dataclasses.dataclass(frozen=True)
class PermNode:
    """One prunable projection inside a layer.

    `can_permute_rows` / `row_blocks` describe the search freedom; for
    physical pruning a tied partner (`tied_to` set) is always searched with
    identity OCP because its rows were already permuted by its tie source.
    """

    path: str
    row_blocks: int = 1
    can_permute_rows: bool = True
    tied_to: str | None = None

    @property
    def is_tied_partner(self) -> bool:
        return self.tied_to is not None


@dataclasses.dataclass(frozen=True)
class PermEdge:
    src: str
    dst: str
    kind: str


@dataclasses.dataclass
class LayerPermGraph:
    """Template graph for one layer type (shared by every layer of it)."""

    nodes: dict[str, PermNode]
    edges: list[PermEdge]
    order: list[str]  # node paths in plan order (producers before consumers)

    def coupling_edges(self) -> list[PermEdge]:
        """Edges whose dst search depends on the src perm being folded."""
        return [e for e in self.edges
                if e.kind in (EdgeKind.PRODUCER, EdgeKind.TIED, EdgeKind.GQA_EXPAND)]

    def out_edges(self, path: str) -> list[PermEdge]:
        return [e for e in self.coupling_edges() if e.src == path]

    def deps(self) -> dict[str, list[str]]:
        """path -> list of node paths whose search must complete first."""
        d: dict[str, list[str]] = {p: [] for p in self.nodes}
        for e in self.coupling_edges():
            d[e.dst].append(e.src)
        return d

    def constraints(self, path: str) -> list[PermEdge]:
        return [e for e in self.edges if e.src == path
                and e.kind in (EdgeKind.RESIDUAL, EdgeKind.BLOCK_DIAGONAL)]

    def validate(self) -> None:
        """Structural validation: endpoints exist, no coupling cycles, a
        node receives rows from at most one producer/tie source."""
        for e in self.coupling_edges():
            if e.src not in self.nodes:
                raise ValueError(f"edge source {e.src!r} is not a planned node")
            if e.dst not in self.nodes:
                raise ValueError(
                    f"{e.kind} edge {e.src!r} -> {e.dst!r}: consumer is not "
                    "a planned node (its columns would silently desync)"
                )
        deps = self.deps()
        for path, srcs in deps.items():
            if len(srcs) > 1:
                raise ValueError(
                    f"node {path!r} receives folds from multiple producers "
                    f"{srcs}: input-column ordering would be ambiguous"
                )
        # Kahn toposort over coupling edges; leftover nodes => cycle
        indeg = {p: len(s) for p, s in deps.items()}
        ready = [p for p, d in indeg.items() if d == 0]
        seen = 0
        while ready:
            n = ready.pop()
            seen += 1
            for e in self.out_edges(n):
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
        if seen != len(self.nodes):
            cyc = [p for p, d in indeg.items() if d > 0]
            raise ValueError(f"permutation-coupling cycle through {cyc}")

    def topo_order(self) -> list[str]:
        """Plan order filtered to a valid topological order (validated)."""
        deps = self.deps()
        done: set[str] = set()
        out: list[str] = []
        pending = list(self.order)
        while pending:
            progressed = False
            for p in list(pending):
                if all(s in done for s in deps[p]):
                    out.append(p)
                    done.add(p)
                    pending.remove(p)
                    progressed = True
            if not progressed:
                raise ValueError(f"unsatisfiable ordering for {pending}")
        return out


def compile_layer_graph(specs) -> LayerPermGraph:
    """Compile a list of PruneSpecs into a validated LayerPermGraph."""
    nodes: dict[str, PermNode] = {}
    edges: list[PermEdge] = []
    order: list[str] = []

    def add_node(node: PermNode):
        if node.path in nodes:
            raise ValueError(f"duplicate plan entry for {node.path!r}")
        nodes[node.path] = node
        order.append(node.path)

    for spec in specs:
        add_node(PermNode(spec.path, row_blocks=spec.row_blocks,
                          can_permute_rows=spec.can_permute_rows))
        if not spec.can_permute_rows:
            edges.append(PermEdge(spec.path, RESIDUAL_SINK, EdgeKind.RESIDUAL))
        if spec.row_blocks > 1:
            edges.append(PermEdge(spec.path, spec.path, EdgeKind.BLOCK_DIAGONAL))
        for t in spec.tied:
            # tied partners inherit the producer's search freedom
            add_node(PermNode(t, row_blocks=spec.row_blocks,
                              can_permute_rows=spec.can_permute_rows,
                              tied_to=spec.path))
            edges.append(PermEdge(spec.path, t, EdgeKind.TIED))
        for cons in spec.consumers:
            cpath, _, mode = cons.partition(":")
            kind = EdgeKind.GQA_EXPAND if mode == "gqa" else EdgeKind.PRODUCER
            edges.append(PermEdge(spec.path, cpath, kind))

    g = LayerPermGraph(nodes=nodes, edges=edges, order=order)
    g.validate()
    return g


@dataclasses.dataclass(frozen=True)
class Container:
    """Where one layer template's layers live on the model: the module
    list ``getattr(model, key)``; tag prefixes report entries."""

    key: str
    tag: str
    graph: LayerPermGraph


@dataclasses.dataclass
class ModelPermGraph:
    containers: list[Container]

    def instances(self):
        """Yield (key, node) over every planned node, plan order."""
        for c in self.containers:
            for path in c.graph.order:
                yield c.key, c.graph.nodes[path]


def compile_model_graph(cfg) -> ModelPermGraph:
    """Compile `zoo.hinm_plan(cfg)` into a ModelPermGraph."""
    from repro_torch.models import zoo

    plan = zoo.hinm_plan(cfg)
    if isinstance(plan, dict) and "enc" in plan:
        return ModelPermGraph([Container(k, k, compile_layer_graph(plan[k]))
                               for k in ("enc", "dec")])
    if isinstance(plan, dict):
        raise NotImplementedError(
            f"{cfg.name}: per-pattern-position stacks are not ported yet; see "
            "ROADMAP.md Queue 1 item 8 (hybrid)")
    return ModelPermGraph([Container("blocks", "blocks", compile_layer_graph(plan))])
