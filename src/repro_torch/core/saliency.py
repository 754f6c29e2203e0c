"""Saliency (importance) scores for pruning decisions (port of
`repro.core.saliency`).

Two estimators, mirroring the paper's choices:
  - magnitude (L1) — used for the CNN/ResNet experiments;
  - second-order diagonal-Fisher — used for DeiT/BERT.
    rho_ij = w_ij^2 * F_ij, with F the empirical diagonal Fisher
    (mean of squared gradients over calibration batches).
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


def magnitude(w: torch.Tensor) -> torch.Tensor:
    return w.abs()


def second_order(w: torch.Tensor, fisher_diag: torch.Tensor) -> torch.Tensor:
    """Diagonal second-order saliency: w^2 * diag(F)."""
    return (w.to(torch.float32) ** 2) * fisher_diag


def _tree_map(fn, *trees):
    """Map over nested dicts / lists / tuples of tensors (None passes)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return None if t0 is None else fn(*trees)


def fisher_diag(grad_fn: Callable[[object], dict], batches: Iterable) -> dict:
    """Accumulate the empirical diagonal Fisher over calibration batches.

    `grad_fn(batch)` must return a tree (nested dicts / lists) of
    per-parameter gradients.  Returns the same tree with mean-of-squares
    leaves (float32)."""
    acc = None
    count = 0
    for batch in batches:
        sq = _tree_map(lambda g: g.to(torch.float32) ** 2, grad_fn(batch))
        acc = sq if acc is None else _tree_map(torch.add, acc, sq)
        count += 1
    if acc is None:
        raise ValueError("fisher_diag needs at least one calibration batch")
    return _tree_map(lambda a: a / count, acc)


def saliency_for(w: torch.Tensor, kind: str = "magnitude",
                 fisher: torch.Tensor | None = None) -> torch.Tensor:
    if kind == "magnitude":
        return magnitude(w)
    if kind == "second_order":
        if fisher is None:
            raise ValueError("second_order saliency requires a fisher diagonal")
        return second_order(w, fisher)
    raise ValueError(f"unknown saliency kind: {kind!r}")
