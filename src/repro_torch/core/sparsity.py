"""HiNM mask construction (port of `repro.core.sparsity`).

All functions take a *saliency* tensor `sal` of the weight's shape (higher
= more important) and return boolean keep-masks.  Every sort is stable,
as `jnp.argsort`/`jnp.sort` are, so ties resolve to the lower index and
the masks are bit-equal to the reference's.

Layout convention: weights are (n_out, n_in); column-wise V x 1 vectors run
along the output-channel axis (axis 0), N:M groups run along the
input-channel axis (axis 1) over the *kept* columns in their current order.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import HiNMConfig


def _ranks_desc(x: torch.Tensor) -> torch.Tensor:
    """Rank of every entry along the last axis in descending order (stable:
    among equal values the lower index ranks first)."""
    order = torch.argsort(x, dim=-1, descending=True, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def nm_mask(sal: torch.Tensor, n: int = 2, m: int = 4, axis: int = -1) -> torch.Tensor:
    """Keep-mask for N:M sparsity along `axis` (top-N of every M group)."""
    if sal.shape[axis] % m != 0:
        raise ValueError(f"axis size {sal.shape[axis]} % M={m} != 0")
    sal = torch.movedim(sal, axis, -1)
    shape = sal.shape
    g = sal.reshape(shape[:-1] + (shape[-1] // m, m))
    mask = (_ranks_desc(g) < n).reshape(shape)
    return torch.movedim(mask, -1, axis)


def vector_scores(sal: torch.Tensor, v: int) -> torch.Tensor:
    """(n_out, n_in) -> (T, n_in): per-tile column-vector saliency sums.

    Accumulated in f32 so the vector selection is invariant to the storage
    dtype (bf16 sums would reorder near-tied columns)."""
    n_out, n_in = sal.shape
    return sal.to(torch.float32).reshape(n_out // v, v, n_in).sum(dim=1)


def vector_mask(sal: torch.Tensor, cfg: HiNMConfig) -> torch.Tensor:
    """Keep-mask for per-tile top-K column-vector pruning. (n_out, n_in)."""
    n_out, n_in = sal.shape
    cfg.validate_shape(n_out, n_in)
    k = cfg.kept_columns(n_in)
    keep_cols = _ranks_desc(vector_scores(sal, cfg.v)) < k        # (T, n_in)
    return torch.repeat_interleave(keep_cols, cfg.v, dim=0)


def kept_column_ids(sal: torch.Tensor, cfg: HiNMConfig) -> torch.Tensor:
    """(T, K) ids of kept columns per tile, in ascending column order."""
    _, n_in = sal.shape
    k = cfg.kept_columns(n_in)
    scores = vector_scores(sal, cfg.v)                             # (T, n_in)
    keep = _ranks_desc(scores) < k
    col_ids = torch.arange(n_in, device=sal.device).expand(scores.shape)
    # sort key: dropped columns pushed to the end, kept stay in column order
    key = torch.where(keep, col_ids, n_in + col_ids)
    return torch.sort(key, dim=-1, stable=True).values[:, :k].to(torch.int32)


def hinm_mask_from_columns(
    sal: torch.Tensor, col_ids: torch.Tensor, cfg: HiNMConfig
) -> torch.Tensor:
    """HiNM keep-mask given an explicit per-tile kept-column order
    `col_ids` (T, K): which columns survive vector pruning and the order
    in which they group into M-groups. Returns a (n_out, n_in) bool mask."""
    n_out, n_in = sal.shape
    t = cfg.num_tiles(n_out)
    k = col_ids.shape[-1]
    idx = col_ids.long()[:, None, :].expand(t, cfg.v, k)
    gathered = sal.reshape(t, cfg.v, n_in).gather(2, idx)          # (T,V,K)
    nm = nm_mask(gathered, cfg.n, cfg.m, axis=-1)
    full = torch.zeros((t, cfg.v, n_in), dtype=torch.bool, device=sal.device)
    full.scatter_(2, idx, nm)
    return full.reshape(n_out, n_in)


def hinm_mask(sal: torch.Tensor, cfg: HiNMConfig) -> torch.Tensor:
    """HiNM keep-mask in the current layout (no permutation search)."""
    return hinm_mask_from_columns(sal, kept_column_ids(sal, cfg), cfg)


def retained_saliency(sal: torch.Tensor, cfg: HiNMConfig) -> torch.Tensor:
    """||M . rho|| for the current layout — the objective of Eq. (1)."""
    return torch.sum(sal * hinm_mask(sal, cfg))


def unstructured_mask(sal: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Global magnitude top-k keep-mask (the paper's 'Unstructured')."""
    keep = max(1, int(round(sal.numel() * (1.0 - sparsity))))
    thresh = torch.topk(sal.reshape(-1), keep).values[-1]
    return sal >= thresh


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return w * mask.to(w.dtype)
