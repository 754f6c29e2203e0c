"""Phase 2 — fold searched permutations along graph edges (port of
`repro.perm.propagate`).

All helpers operate on STORED orientation (n_in, n_out) weights — HiNM rows
are stored columns. `perm` may carry a leading expert axis (E, n_out) for
expert stacks; weight tensors then carry a matching (E, n_in, n_out).
Permutations are numpy index arrays; weights are tensors, and the results
are new tensors on the weight's device.

Folding rules by edge kind:
  self / tied         : permute the stored n_out axis (+ bias)
  producer → consumer : permute the consumer's stored n_in axis
  gqa-expand          : expand the within-kv-head perm to query heads
                        first, then permute the consumer's n_in axis
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gyro import as_index


def gqa_expand_perm(perm_v: np.ndarray, n_kv: int, n_heads: int, hd: int) -> np.ndarray:
    """Expand a (KV*hd) within-kv-head row perm to the (H*hd) wo-column perm."""
    g = n_heads // n_kv
    out = np.empty(n_heads * hd, dtype=np.int64)
    for h in range(n_heads):
        kv = h // g
        local = perm_v[kv * hd : (kv + 1) * hd] - kv * hd
        out[h * hd : (h + 1) * hd] = h * hd + local
    return out


def permute_out(w: torch.Tensor, perm) -> torch.Tensor:
    """Permute the stored n_out axis (axis -1) — producer row perm; an
    expert stack (E, n_in, n_out) by its (E, n_out) perms."""
    if w.dim() == 3:
        return torch.stack([permute_out(w[e], perm[e]) for e in range(w.shape[0])])
    return w.index_select(1, as_index(perm, w))


def permute_bias(b: torch.Tensor, perm) -> torch.Tensor:
    if b.dim() == 2:
        return torch.stack([permute_bias(b[e], perm[e]) for e in range(b.shape[0])])
    return b.index_select(0, as_index(perm, b))


def permute_in(w: torch.Tensor, perm) -> torch.Tensor:
    """Permute the stored n_in axis — consumer column perm; an expert stack
    by its (E, n_in) perms, or each expert by one (n_in,) perm."""
    if w.dim() == 3:
        p = perm if perm.ndim == 2 else np.broadcast_to(perm, (w.shape[0],) + perm.shape)
        return torch.stack([permute_in(w[e], p[e]) for e in range(w.shape[0])])
    return w.index_select(0, as_index(perm, w))


def _rows(perm: np.ndarray) -> np.ndarray:
    """A perm, or a stack's perms, as rows."""
    return perm.reshape(-1, perm.shape[-1])


def is_identity(perm) -> bool:
    return all(np.array_equal(p, np.arange(p.shape[0])) for p in _rows(perm))


# ---------------------------------------------------------------------------
# consistency validation
# ---------------------------------------------------------------------------


def check_bijection(perm: np.ndarray, what: str) -> None:
    for p in _rows(perm):
        if not np.array_equal(np.sort(p), np.arange(p.shape[0])):
            raise ValueError(f"{what}: folded perm is not a bijection")


def check_identity(perm: np.ndarray, what: str) -> None:
    if not is_identity(perm):
        raise ValueError(f"{what}: residual-identity constraint violated")


def check_block_diagonal(perm: np.ndarray, row_blocks: int, what: str) -> None:
    bs = perm.shape[-1] // row_blocks
    if any(not np.array_equal(p // bs, np.arange(p.shape[0]) // bs) for p in _rows(perm)):
        raise ValueError(
            f"{what}: block-diagonal constraint violated "
            f"(a row crossed one of the {row_blocks} blocks)"
        )
