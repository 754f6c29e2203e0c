"""Model-facing entry points for HiNM pruning with gyro-permutation (port
of `repro.core.api`).

Layer-coupling rules: OCP physically reorders a producer's output rows;
every consumer of those channels sees the permutation folded into either
(a) its own weight columns before its gyro search runs, or (b) its
`vec_idx` gather — which is free at runtime, the paper's key trick.
Residual-constrained rows use identity OCP; head-structured rows restrict
OCP to within-block permutations via `row_blocks`.

Model-level coupling lives in `repro_torch.perm` (the PermGraph engine);
this module is the single-matrix entry point sharing the same search and
realize phases.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.core import saliency as saliency_mod
from repro_torch.core.types import HiNMConfig, PackedHiNM

Method = Literal["gyro", "noperm", "icp_only", "ocp_only", "v1", "v2"]


@dataclasses.dataclass
class PrunedLinear:
    """Result of pruning one (n_out, n_in) projection."""

    packed: PackedHiNM            # rows in out_perm order
    mask: torch.Tensor            # (n_out, n_in) keep-mask in ORIGINAL row order
    out_perm: np.ndarray          # (n_out,) row permutation applied before packing
    retained: float
    total: float

    @property
    def retained_fraction(self) -> float:
        return self.retained / max(self.total, 1e-30)


def prune_matrix(
    w: torch.Tensor,
    cfg: HiNMConfig,
    method: Method = "gyro",
    saliency_kind: str = "magnitude",
    fisher: torch.Tensor | None = None,
    rng: np.random.Generator | None = None,
    row_blocks: int = 1,
    ocp_iters: int = 24,
    icp_iters: int = 16,
    cache=None,
) -> PrunedLinear:
    """Prune one projection to HiNM sparsity with the chosen permutation.

    The search runs on `w`'s device. `row_blocks` restricts OCP to
    permutations within `n_out / row_blocks` sized row blocks
    (block-diagonal permutation). `cache` is an optional
    `repro_torch.perm.PermCache`.
    """
    from repro_torch.perm import realize as perm_realize
    from repro_torch.perm.search import search_projection

    rng = rng or np.random.default_rng(0)
    n_out, n_in = w.shape
    cfg.validate_shape(n_out, n_in)
    if n_out % row_blocks != 0:
        raise ValueError(f"n_out={n_out} % row_blocks={row_blocks} != 0")
    bs = n_out // row_blocks
    if bs % cfg.v != 0:
        raise ValueError(f"row block {bs} % V={cfg.v} != 0")

    sal = saliency_mod.saliency_for(w, saliency_kind, fisher).to(torch.float32)
    out_perm, col_order = search_projection(
        sal, sal, cfg, method=method, can_permute_rows=True,
        row_blocks=row_blocks, rng=rng, ocp_iters=ocp_iters,
        icp_iters=icp_iters, cache=cache,
    )

    # realize against the SEARCH saliency (fisher-informed when requested),
    # not the magnitude default of the model path
    r = perm_realize.realize_matrix(w, out_perm, col_order, cfg, sal=sal)
    mask = perm_realize.mask_to_original_rows(r.mask_p, out_perm, axis=0)
    total = float(sal.sum())
    return PrunedLinear(
        packed=r.packed,
        mask=mask,
        out_perm=out_perm,
        retained=r.retained * total,
        total=total,
    )


def masked_dense(w: torch.Tensor, pruned: PrunedLinear) -> torch.Tensor:
    """Weight with the HiNM mask applied, in original row order (training)."""
    return w * pruned.mask.to(w.dtype)
