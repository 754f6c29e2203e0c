"""dense <-> packed HiNM conversion (port of `repro.core.packing`).

`pack` operates on a weight whose rows are already OCP-permuted; the column
order argument (`col_ids`, shape (T, K)) carries both the vector-pruning
selection and the ICP permutation, and is stored verbatim as `vec_idx`, so
the kernel's indexed gather makes the runtime reorder free.
"""
from __future__ import annotations

import torch

from repro_torch.core import sparsity
from repro_torch.core.types import HiNMConfig, PackedHiNM


def pack(
    w: torch.Tensor,
    cfg: HiNMConfig,
    col_ids: torch.Tensor | None = None,
    sal: torch.Tensor | None = None,
) -> PackedHiNM:
    """Compress (n_out, n_in) -> PackedHiNM.

    If `col_ids` is None, the default (no-permutation) kept-column order is
    derived from `sal` (defaults to |w|).
    """
    n_out, n_in = w.shape
    cfg.validate_shape(n_out, n_in)
    if sal is None:
        sal = w.abs()
    if col_ids is None:
        col_ids = sparsity.kept_column_ids(sal, cfg)
    t = cfg.num_tiles(n_out)
    k = col_ids.shape[-1]
    g = k // cfg.m

    idx = col_ids.long()[:, None, :].expand(t, cfg.v, k)
    w_g = w.reshape(t, cfg.v, n_in).gather(2, idx)                   # (T,V,K)
    sal_g = sal.reshape(t, cfg.v, n_in).gather(2, idx)

    w_grp = w_g.reshape(t, cfg.v, g, cfg.m)
    sal_grp = sal_g.reshape(t, cfg.v, g, cfg.m)
    order = torch.argsort(sal_grp, dim=-1, descending=True, stable=True)
    top = torch.sort(order[..., : cfg.n], dim=-1, stable=True).values  # ascending slots
    vals = w_grp.gather(3, top)                                      # (T,V,G,N)

    kn = g * cfg.n
    return PackedHiNM(
        vals=vals.reshape(t, cfg.v, kn).contiguous(),
        vec_idx=col_ids.to(torch.int32).contiguous(),
        nm_idx=top.reshape(t, cfg.v, kn).to(torch.int8).contiguous(),
        n_out=n_out,
        n_in=n_in,
        config=cfg,
    )


def unpack(p: PackedHiNM) -> torch.Tensor:
    """Reconstruct the masked-dense (n_out, n_in) weight from packed form."""
    cfg = p.config
    t, v, kn = p.vals.shape
    g = kn // cfg.n
    k = g * cfg.m
    grp = torch.zeros((t, v, g, cfg.m), dtype=p.vals.dtype, device=p.vals.device)
    grp.scatter_(3, p.nm_idx.reshape(t, v, g, cfg.n).long(),
                 p.vals.reshape(t, v, g, cfg.n))
    full = torch.zeros((t, v, p.n_in), dtype=p.vals.dtype, device=p.vals.device)
    full.scatter_(2, p.vec_idx.long()[:, None, :].expand(t, v, k),
                  grp.reshape(t, v, k))
    return full.reshape(p.n_out, p.n_in)


def pack_mask(p: PackedHiNM) -> torch.Tensor:
    """Boolean keep-mask implied by a packed tensor (for validation)."""
    ones = PackedHiNM(
        vals=torch.ones_like(p.vals),
        vec_idx=p.vec_idx,
        nm_idx=p.nm_idx,
        n_out=p.n_out,
        n_in=p.n_in,
        config=p.config,
    )
    return unpack(ones) > 0
