"""Phase 3 — pack + mask + report from search results (port of
`repro.perm.realize`).

Shared by `prune_model` and `prune_matrix`. All functions here take HiNM
orientation (n_out, n_in); `realize_stored` adapts the stored (n_in, n_out)
layout the models use.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import packing, sparsity
from repro_torch.core.gyro import as_index
from repro_torch.core.types import HiNMConfig, PackedHiNM


@dataclasses.dataclass
class Realized:
    """Packed/masked projection. Tensors are HiNM orientation (n_out, n_in);
    `w_p` and `mask_p` are aligned to the PERMUTED row order."""

    w_p: torch.Tensor
    mask_p: torch.Tensor
    packed: PackedHiNM | None
    retained: float       # fraction of the saliency kept


def realize_matrix(w: torch.Tensor, out_perm, col_order, hcfg: HiNMConfig,
                   pack: bool = True, sal=None) -> Realized:
    """Pack one (n_out, n_in) weight given search results.

    Packing and the mask both select N:M survivors from the same saliency
    (`sal` in ORIGINAL row order, defaulting to the permuted weight's
    magnitude), so their supports are identical.
    """
    w_p = w.index_select(0, as_index(out_perm, w))
    if sal is None:
        sal_p = w_p.to(torch.float32).abs()
    else:
        sal_p = torch.as_tensor(sal, dtype=torch.float32, device=w.device).index_select(
            0, as_index(out_perm, w))
    col = as_index(col_order, w).to(torch.int32)
    packed = packing.pack(w_p, hcfg, col_ids=col, sal=sal_p) if pack else None
    mask_p = sparsity.hinm_mask_from_columns(sal_p, col, hcfg)
    retained = float((sal_p * mask_p).sum() / torch.clamp(sal_p.sum(), min=1e-30))
    return Realized(w_p=w_p, mask_p=mask_p, packed=packed, retained=retained)


def realize_stored(w_stored: torch.Tensor, out_perm, col_order, hcfg: HiNMConfig,
                   pack: bool = True):
    """Stored-orientation wrapper: (n_in, n_out) in, stored-orientation out.

    Returns (w_permuted, mask, packed, retained) with w/mask transposed
    back to storage layout.
    """
    r = realize_matrix(w_stored.T, out_perm, col_order, hcfg, pack=pack)
    return r.w_p.T.contiguous(), r.mask_p.T.contiguous(), r.packed, r.retained


def mask_to_original_rows(mask_p: torch.Tensor, out_perm, axis: int = 0) -> torch.Tensor:
    """Map a permuted-row mask back to the original row order."""
    inv = np.argsort(out_perm)
    return mask_p.index_select(axis, as_index(inv, mask_p))
