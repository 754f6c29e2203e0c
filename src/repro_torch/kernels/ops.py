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
`paged_attention`'s "auto" defers to `perf_knobs.KNOBS.paged_attn`, the
knob a scheduler resolves once.

Every `paged_attention` decision made while a program is being built
(`building()`: the scheduler's graph cache opens it around a graph
capture, or a key's first eager run on the CPU) lands in the process-
global registry as ``paged_attn_dispatch{decision, reason}`` — once per
program, never per replay or per eager step, as the reference counts once
per XLA trace.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch import perf_knobs

from repro_torch.core.types import PackedHiNM
from repro_torch.distributed import collectives
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


_building = False


@contextlib.contextmanager
def building():
    """Count dispatch decisions inside the block (see the module docstring)."""
    global _building
    prev, _building = _building, True
    try:
        yield
    finally:
        _building = prev


def _count_dispatch(decision: str, reason: str) -> None:
    """Tally a paged-attention backend decision in the global metrics
    registry while a program is being built.  Imported lazily: the serve
    package sits above the kernel layer in the import graph."""
    if not _building:
        return
    from repro_torch.serve.telemetry import metrics as _tm

    _tm.GLOBAL.counter("paged_attn_dispatch",
                       labels={"decision": decision, "reason": reason}).inc()


@dataclasses.dataclass
class TileShard(PackedHiNM):
    """This rank's tiles of a packed weight whose tile axis T is sharded
    over the mesh's 'model' axis (`distributed.sharding`'s spec): a packed
    matrix of its own, ``n_out`` its T_local * V rows, ``full_n_out`` the
    whole weight's.  Tiles are independent, so the rank's K1 over them
    gives its block of the output columns with no collective."""

    full_n_out: int = 0


def hinm_spmm_shard_map(x: torch.Tensor, p: PackedHiNM, backend: str = "auto",
                        variant: str | None = None) -> torch.Tensor | None:
    """The T-sharded packed matmul (the reference's `hinm_spmm_shard_map`):
    this rank's rows of x (its batch shard) against its own tiles — K1 on
    a CUDA tensor, the plain version on a CPU one — giving its block of
    the output columns, sharded over 'model', with no collective inside.
    Returns None where the reference's does (no mesh, no 'model' axis, an
    expert stack, a weight whose tiles are not sharded), and the caller
    takes the whole weight instead."""
    ctx = collectives.current()
    if ctx is None or ctx.size("model") == 0:
        return None
    if not isinstance(p, TileShard) or p.vals.dim() != 3:
        return None
    ctx.note("hinm_spmm_shard_map")
    local = _local(p)
    if _resolve(backend, x, extra=("oracle",)) == "cuda":
        # the whole weight's plan: the ranks' blocks are the whole launch's bits
        return _spmm.hinm_spmm(x, local, variant, plan_tiles=p.full_n_out // p.config.v)
    return hinm_matmul(x, local, backend, variant)


def _local(p: TileShard) -> PackedHiNM:
    return PackedHiNM(p.vals, p.vec_idx, p.nm_idx, p.n_out, p.n_in, p.config)


def hinm_matmul(x: torch.Tensor, p: PackedHiNM, backend: str = "auto",
                variant: str | None = None) -> torch.Tensor:
    """y (..., n_out) = x (..., n_in) @ W_packed^T (rows in packed order).
    For an expert stack (`p`'s fields lead with E) x is (E, C, n_in) and
    y (E, C, n_out): one launch over every expert, each against its own
    weights.  `variant` picks the CUDA kernel's variant ("rows" or "mma";
    None = its dispatch's choice); the plain versions ignore it.

    A `TileShard` (a sharded step's weight) runs the T-sharded matmul
    under `KNOBS.packed_shard_map`, and its output blocks are gathered over
    'model' for the consumer; else its tiles are gathered into the whole
    weight first."""
    if isinstance(p, TileShard):
        y = _tile_sharded(x.reshape(-1, x.shape[-1]), p, backend, variant)
        return y.reshape(*x.shape[:-1], p.full_n_out)
    stack = p.vals.dim() == 4
    if stack and (x.dim() != 3 or x.shape[0] != p.vals.shape[0]):
        raise ValueError(f"hinm_matmul: an expert stack of {p.vals.shape[0]} takes x "
                         f"(E, C, n_in), got {tuple(x.shape)}")
    lead = x.shape[:-1]
    xb = x if stack else x.reshape(-1, x.shape[-1])
    backend = _resolve(backend, x, extra=("oracle",))
    if backend == "cuda":
        y = _spmm.hinm_spmm(xb, p, variant)
    elif backend == "torch":
        y = _spmm.hinm_spmm_ref(xb, p)
    else:
        y = _spmm.hinm_spmm_oracle(xb, p)
    return y if stack else y.reshape(*lead, p.n_out)


def _tile_sharded(x, p: TileShard, backend, variant) -> torch.Tensor:
    ctx = collectives.current()
    if ctx is None:
        raise ValueError("a TileShard weight runs only inside a sharded step "
                         "(train.steps.shard_serve_step)")
    y = None
    if perf_knobs.KNOBS.packed_shard_map:
        y = hinm_spmm_shard_map(x, p, backend, variant)
    if y is not None:
        return collectives.gather_cat(y, ctx.mesh, "model", dim=-1)
    whole = PackedHiNM(*(collectives.gather_cat(getattr(p, f), ctx.mesh, "model", dim=-3 if
                                                f != "vec_idx" else -2)
                         for f in ("vals", "vec_idx", "nm_idx")),
                       p.full_n_out, p.n_in, p.config)
    return hinm_matmul(x, whole, backend, variant)


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
    dispatch it never returns None to defer to a gather path.  The
    decision counts as ``kernel`` or ``plain``, by "auto" (``auto-cuda`` /
    ``auto-cpu``) or ``forced``."""
    if backend == "auto":
        backend = perf_knobs.KNOBS.paged_attn
    chosen = _resolve(backend, q)
    if backend == "auto":
        reason = "auto-cuda" if chosen == "cuda" else "auto-cpu"
    else:
        reason = "forced"
    _count_dispatch("kernel" if chosen == "cuda" else "plain", reason)
    if chosen == "cuda":
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
