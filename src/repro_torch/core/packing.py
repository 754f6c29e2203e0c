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


def stack(packs: list[PackedHiNM]) -> PackedHiNM:
    """One expert stack from per-expert packs of one shape: every field
    gains a leading E."""
    p0 = packs[0]
    return PackedHiNM(
        vals=torch.stack([p.vals for p in packs]),
        vec_idx=torch.stack([p.vec_idx for p in packs]),
        nm_idx=torch.stack([p.nm_idx for p in packs]),
        n_out=p0.n_out,
        n_in=p0.n_in,
        config=p0.config,
    )


def pack_stored(w: torch.Tensor, cfg: HiNMConfig) -> PackedHiNM:
    """Pack a stored-orientation (n_in, n_out) weight with no permutation;
    an expert stack (E, n_in, n_out) expert by expert, as the reference
    vmaps `pack` over it."""
    if w.dim() == 3:
        return stack([pack(we.T, cfg) for we in w])
    return pack(w.T, cfg)


def unpack_stored(p: PackedHiNM) -> torch.Tensor:
    """The masked-dense stored-orientation weight of a pack (an expert
    stack's (E, n_in, n_out))."""
    if p.vals.dim() == 4:
        return torch.stack([unpack(p.expert(e)).T for e in range(p.vals.shape[0])])
    return unpack(p).T.contiguous()


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
