"""Public dispatch for the port's kernels (port of `repro.kernels.ops`).

Behind it: `hinm_matmul` -> K1 ``hinm_spmm`` (every packed projection),
`paged_attention` -> K2 ``paged_decode_attn`` (paged decode attention),
`nm_apply` -> K3 ``nm_select`` (N:M magnitude select; only this public
entry point reaches it, as in the reference).

``backend="auto"`` launches the CUDA kernel for a CUDA tensor and takes
the plain PyTorch version for a CPU tensor; the choice rests on where the
tensor lies and nothing else.  ``"torch"`` (and ``"oracle"`` for the
packed matmul) explicitly asks for a plain version: the tests and
`chip_smoke.py`'s comparisons use it.  ``"cuda"`` asks for the kernel and
raises on a CPU tensor.  There is no fallback: a CUDA tensor launches the
kernel or raises (missing nvcc, failed build, failed launch).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PackedHiNM
from repro_torch.kernels import hinm_spmm as _spmm
from repro_torch.kernels import nm_select as _nmsel
from repro_torch.kernels import paged_attn as _pattn

BACKENDS = ("auto", "cuda", "torch")


def _resolve(backend: str, t: torch.Tensor, extra=()) -> str:
    if backend not in BACKENDS + tuple(extra):
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS + tuple(extra)}")
    if backend == "auto":
        return "cuda" if t.device.type == "cuda" else "torch"
    return backend


def hinm_matmul(x: torch.Tensor, p: PackedHiNM, backend: str = "auto",
                variant: str | None = None) -> torch.Tensor:
    """y (..., n_out) = x (..., n_in) @ W_packed^T (rows in packed order).
    `variant` picks the CUDA kernel's variant ("rows" or "mma"; None = its
    dispatch's choice); the plain versions ignore it."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1])
    backend = _resolve(backend, x, extra=("oracle",))
    if backend == "cuda":
        y = _spmm.hinm_spmm(xb, p, variant)
    elif backend == "torch":
        y = _spmm.hinm_spmm_ref(xb, p)
    else:
        y = _spmm.hinm_spmm_oracle(xb, p)
    return y.reshape(*lead, p.n_out)


def paged_attention(
    q: torch.Tensor,          # (B, s, H, hd)
    k_pool: torch.Tensor,     # (n_pages, page, KV, hd)
    v_pool: torch.Tensor,     # (n_pages, page, KV, hd)
    kpos_pool: torch.Tensor,  # (n_pages, page) int32
    bt: torch.Tensor,         # (B, n_bt) int32
    q_pos: torch.Tensor,      # (B, s) int32
    *,
    window: int = 0,
    backend: str = "auto",
) -> torch.Tensor:
    """Block-table-resolved decode attention over a paged KV pool.
    Returns (B, s, H, hd) in q's dtype — always a result: unlike the JAX
    dispatch it never returns None to defer to a gather path."""
    if _resolve(backend, q) == "cuda":
        return _pattn.paged_decode_attn(q, k_pool, v_pool, kpos_pool, bt, q_pos,
                                        window=window)
    return _pattn.paged_decode_attn_ref(q, k_pool, v_pool, kpos_pool, bt, q_pos,
                                        window=window)


def nm_apply(w: torch.Tensor, nn: int = 2, mm: int = 4, backend: str = "auto") -> torch.Tensor:
    """Apply N:M magnitude selection along the last axis (any leading dims)."""
    if w.shape[-1] % mm != 0:
        raise ValueError(f"cols={w.shape[-1]} % M={mm} != 0")
    wb = w.reshape(-1, w.shape[-1])
    if _resolve(backend, w) == "cuda":
        out = _nmsel.nm_select(wb, nn, mm)
    else:
        out = _nmsel.nm_select_ref(wb, nn, mm)
    return out.reshape(w.shape)
