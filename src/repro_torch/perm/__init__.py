"""PermGraph — declarative permutation-propagation for HiNM pruning (port
of `repro.perm`).

A model's `hinm_plan` compiles into an explicit graph of prunable nodes and
typed coupling edges; pruning then runs as three separated phases (search,
propagate, realize).
"""
from repro_torch.perm.cache import PermCache
from repro_torch.perm.engine import ModelPermEngine
from repro_torch.perm.graph import (
    EdgeKind,
    LayerPermGraph,
    ModelPermGraph,
    PermEdge,
    PermNode,
    compile_model_graph,
)

__all__ = [
    "EdgeKind",
    "LayerPermGraph",
    "ModelPermEngine",
    "ModelPermGraph",
    "PermCache",
    "PermEdge",
    "PermNode",
    "compile_model_graph",
]
