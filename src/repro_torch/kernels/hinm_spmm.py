"""HiNM packed matmul: the CUDA kernel's wrapper and its plain versions.

Port of `repro.kernels.hinm_spmm` (the TPU kernel `hinm_spmm` / `_kernel`).
The kernel lives in `src/repro_torch/csrc/hinm_spmm.cu` (design and bound
noted there) and keeps the port's public layout, ``x (B, n_in) ->
y (B, n_out)`` with rows in packed (OCP) order.  Its C dispatch picks one of
two variants by dtype and batch (`variant` names it): "rows" (a warp per
output row on CUDA cores; f32, and bf16 decode batches) or "mma" (tensor
cores through mma.sync; larger bf16 batches, reading a transposed copy of x
and, for a split K, f32 partial sums from scratch the wrapper allocates).
Its plain versions sit beside it: `hinm_spmm_ref` (the gather formulation)
and `hinm_spmm_oracle` (unpack + matmul).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.types import PackedHiNM
from repro_torch.kernels import build
from repro_torch.kernels.ref import hinm_spmm_oracle
from repro_torch.kernels.ref import hinm_spmm_xla as hinm_spmm_ref

__all__ = ["hinm_spmm", "hinm_spmm_ref", "hinm_spmm_oracle", "variant"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("rows", "mma")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("hinm_spmm")
        args = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.hinm_spmm_launch.argtypes = args
        lib.hinm_spmm_launch_variant.argtypes = [ctypes.c_int] + args
        lib.hinm_spmm_launch.restype = lib.hinm_spmm_launch_variant.restype = ctypes.c_int
        lib.hinm_spmm_variant.argtypes = [ctypes.c_int] * 4
        lib.hinm_spmm_variant.restype = ctypes.c_int
        lib.hinm_spmm_scratch_elems.argtypes = [ctypes.c_int] * 6
        lib.hinm_spmm_scratch_elems.restype = ctypes.c_longlong
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _variant(b: int, v: int, m: int, dtype: int) -> int:
    """The C dispatch's variant index for a call."""
    return _load().hinm_spmm_variant(b, v, m, dtype)


@functools.lru_cache(maxsize=None)
def _scratch(var: int, b: int, n_in: int, t: int, v: int, k: int) -> int:
    """bf16 elements of scratch a call of variant index `var` needs."""
    return _load().hinm_spmm_scratch_elems(var, b, n_in, t, v, k)


def variant(b: int, p: PackedHiNM, dtype: torch.dtype) -> str:
    """The variant ("rows" or "mma") that the kernel runs for a batch of `b`
    rows of `dtype` against `p` (builds the library on first use)."""
    return VARIANTS[_variant(b, p.config.v, p.config.m, _DTYPES[dtype])]


def hinm_spmm(x: torch.Tensor, p: PackedHiNM, variant: str | None = None) -> torch.Tensor:
    """y (B, n_out) = x (B, n_in) @ W_packed^T through the CUDA kernel.

    Takes CUDA tensors only (the dispatch in `ops.hinm_matmul` sends CPU
    tensors to the plain versions); raises on anything the kernel does not
    take (a shape, or shared memory, beyond what the variant takes: the C
    side returns cudaErrorInvalidValue).  `variant` ("rows" or "mma")
    overrides the C dispatch's choice: the speculative verify holds its
    launches to the variant decode runs (`transformer.verify_step`), and
    chip_smoke measures the crossover with it.  Counts one launch in
    ``hinm_spmm.launches``."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"hinm_spmm: unknown variant {variant!r}; choose from {VARIANTS}")
    cfg = p.config
    t, v, kn = p.vals.shape
    k = p.vec_idx.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"hinm_spmm: the CUDA kernel takes CUDA tensors, got {x.device}")
    for name, a in (("vals", p.vals), ("nm_idx", p.nm_idx), ("vec_idx", p.vec_idx)):
        if a.device != x.device:
            raise ValueError(f"hinm_spmm: {name} on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"hinm_spmm: {name} must be contiguous")
    if x.dtype not in _DTYPES or p.vals.dtype != x.dtype:
        raise ValueError(f"hinm_spmm: x {x.dtype} and vals {p.vals.dtype} must "
                         "both be float32 or both bfloat16")
    if p.nm_idx.dtype != torch.int8 or p.vec_idx.dtype != torch.int32:
        raise ValueError("hinm_spmm: nm_idx must be int8 and vec_idx int32")
    if (x.dim() != 2 or x.shape[1] != p.n_in or t * v != p.n_out
            or p.nm_idx.shape != p.vals.shape or p.vec_idx.shape != (t, k)
            or k % cfg.m or kn != k // cfg.m * cfg.n or v % 8):
        raise ValueError(
            f"hinm_spmm: unsupported shapes x {tuple(x.shape)}, vals "
            f"{tuple(p.vals.shape)}, vec_idx {tuple(p.vec_idx.shape)}, "
            f"{cfg.n}:{cfg.m} (V must be a multiple of 8, K of M)")
    x = x.contiguous()
    b = x.shape[0]
    y = torch.empty((b, p.n_out), dtype=x.dtype, device=x.device)
    if b == 0:
        return y
    dt = _DTYPES[x.dtype]
    var = _variant(b, v, cfg.m, dt) if variant is None else VARIANTS.index(variant)
    n_scratch = _scratch(var, b, p.n_in, t, v, k)
    scratch = (torch.empty(n_scratch, dtype=x.dtype, device=x.device) if n_scratch
               else None)
    args = (x.data_ptr(), p.vals.data_ptr(), p.nm_idx.data_ptr(), p.vec_idx.data_ptr(),
            y.data_ptr(), scratch.data_ptr() if n_scratch else None, b, p.n_in, t, v, k, kn,
            cfg.n, cfg.m, dt, torch.cuda.current_stream(x.device).cuda_stream)
    lib = _load()
    status = (lib.hinm_spmm_launch(*args) if variant is None
              else lib.hinm_spmm_launch_variant(var, *args))
    build.check(status, "hinm_spmm")
    hinm_spmm.launches += 1
    return y


hinm_spmm.launches = 0
