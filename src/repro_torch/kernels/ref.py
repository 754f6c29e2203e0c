"""Plain PyTorch versions of the packed matmul (port of `repro.kernels.ref`).

They serve CPU tensors and explicit ``backend="torch"``/``"oracle"``
requests, and are what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.sparsity import _ranks_desc
from repro_torch.core.types import PackedHiNM


def decompress_tiles(
    vals: torch.Tensor, nm_idx: torch.Tensor, m: int, n: int
) -> torch.Tensor:
    """(T, V, Kn) packed values + slots -> (T, V, K) dense kept-column tiles."""
    t, v, kn = vals.shape
    g = kn // n
    dense = torch.zeros((t, v, g, m), dtype=vals.dtype, device=vals.device)
    dense.scatter_(3, nm_idx.reshape(t, v, g, n).long(), vals.reshape(t, v, g, n))
    return dense.reshape(t, v, g * m)


def _per_expert(fn, x, p, *args):
    """An expert stack's plain version: `fn` on each expert's rows
    (x (E, C, n_in)) against its own weights, stacked."""
    return torch.stack([fn(x[e], p.expert(e), *args) for e in range(p.vals.shape[0])])


def hinm_spmm_oracle(x: torch.Tensor, p: PackedHiNM) -> torch.Tensor:
    """Ground truth: unpack to masked-dense and matmul. x: (B, n_in), or
    (E, C, n_in) against an expert stack."""
    if p.vals.dim() == 4:
        return _per_expert(hinm_spmm_oracle, x, p)
    w = packing.unpack(p)  # (n_out, n_in), rows in packed (OCP) order
    return (x.float() @ w.float().T).to(x.dtype)


GATHER_PATH_MAX_ROWS = 1024
TILE_CHUNK_BYTES = 256 * 1024 * 1024


def _gather_matmul(x, vec_idx, vals, nm_idx, mm, nn, out_dtype):
    """(B, n_in) x packed tiles -> (B, T, V): gather + compressed contraction
    with f32 accumulation (bf16 operands are widened exactly)."""
    t, k = vec_idx.shape
    xg = x.index_select(1, vec_idx.reshape(-1).long()).reshape(x.shape[0], t, k)
    w = decompress_tiles(vals, nm_idx, mm, nn)                 # (T', V, K)
    y = torch.einsum("btk,tvk->btv", xg.float(), w.float())
    return y.to(out_dtype)


def hinm_spmm_xla(x: torch.Tensor, p: PackedHiNM,
                  chunk_bytes: int | None = None) -> torch.Tensor:
    """Gather formulation of the packed matmul: per-tile gather of the kept
    input channels by `vec_idx`, N:M decompression, contraction over the K
    kept columns only.  For more than 1024 rows the (B, T, K) gather copy
    is bounded by processing tiles in chunks (same FLOPs, bounded memory).
    An expert stack runs expert by expert (x (E, C, n_in))."""
    if p.vals.dim() == 4:
        return _per_expert(hinm_spmm_xla, x, p, chunk_bytes)
    cfg = p.config
    b = x.shape[0]
    t, v, kn = p.vals.shape
    k = p.vec_idx.shape[-1]
    if b <= GATHER_PATH_MAX_ROWS:
        y = _gather_matmul(x, p.vec_idx, p.vals, p.nm_idx, cfg.m, cfg.n, x.dtype)
        return y.reshape(b, p.n_out)
    budget = chunk_bytes or TILE_CHUNK_BYTES
    tc = min(t, max(1, budget // max(1, b * k * x.element_size())))
    while t % tc:
        tc -= 1
    ys = [_gather_matmul(x, p.vec_idx[i:i + tc], p.vals[i:i + tc],
                         p.nm_idx[i:i + tc], cfg.m, cfg.n, x.dtype)
          for i in range(0, t, tc)]                            # (B, tc, V) each
    return torch.cat(ys, dim=1).reshape(b, p.n_out)


def nm_select_ref(w: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """Plain version of the N:M select: keep the top-N of each M group
    along the last axis by |w| (stable: ties to the lower index), +0
    elsewhere; kept values pass through bit for bit."""
    shape = w.shape
    if shape[-1] % m != 0:
        raise ValueError(f"cols={shape[-1]} % M={m} != 0")
    g = w.reshape(shape[:-1] + (shape[-1] // m, m))
    return torch.where(_ranks_desc(g.abs()) < n, g, torch.zeros((), dtype=w.dtype,
                                                                device=w.device)).reshape(shape)
