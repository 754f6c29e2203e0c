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
    """Permute the stored n_out axis (axis -1) — producer row perm."""
    return w.index_select(1, as_index(perm, w))


def permute_bias(b: torch.Tensor, perm) -> torch.Tensor:
    return b.index_select(0, as_index(perm, b))


def permute_in(w: torch.Tensor, perm) -> torch.Tensor:
    """Permute the stored n_in axis — consumer column perm."""
    return w.index_select(0, as_index(perm, w))


def is_identity(perm) -> bool:
    return np.array_equal(perm, np.arange(perm.shape[0]))


# ---------------------------------------------------------------------------
# consistency validation
# ---------------------------------------------------------------------------


def check_bijection(perm: np.ndarray, what: str) -> None:
    if not np.array_equal(np.sort(perm), np.arange(perm.shape[0])):
        raise ValueError(f"{what}: folded perm is not a bijection")


def check_identity(perm: np.ndarray, what: str) -> None:
    if not is_identity(perm):
        raise ValueError(f"{what}: residual-identity constraint violated")


def check_block_diagonal(perm: np.ndarray, row_blocks: int, what: str) -> None:
    bs = perm.shape[0] // row_blocks
    if not np.array_equal(perm // bs, np.arange(perm.shape[0]) // bs):
        raise ValueError(
            f"{what}: block-diagonal constraint violated "
            f"(a row crossed one of the {row_blocks} blocks)"
        )
