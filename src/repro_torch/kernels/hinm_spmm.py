"""HiNM packed matmul: the CUDA kernel's wrapper and its plain versions.

Port of `repro.kernels.hinm_spmm` (the TPU kernel `hinm_spmm` / `_kernel`).
The kernel lives in `src/repro_torch/csrc/hinm_spmm.cu` (design and bound
noted there) and keeps the port's public layout, ``x (B, n_in) ->
y (B, n_out)`` with rows in packed (OCP) order.  Its plain versions sit
beside it: `hinm_spmm_ref` (the gather formulation) and
`hinm_spmm_oracle` (unpack + matmul).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.types import PackedHiNM
from repro_torch.kernels import build
from repro_torch.kernels.ref import hinm_spmm_oracle
from repro_torch.kernels.ref import hinm_spmm_xla as hinm_spmm_ref

__all__ = ["hinm_spmm", "hinm_spmm_ref", "hinm_spmm_oracle"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("hinm_spmm").hinm_spmm_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def hinm_spmm(x: torch.Tensor, p: PackedHiNM) -> torch.Tensor:
    """y (B, n_out) = x (B, n_in) @ W_packed^T through the CUDA kernel.

    Takes CUDA tensors only (the dispatch in `ops.hinm_matmul` sends CPU
    tensors to the plain versions); raises on anything the kernel does not
    take.  Counts one launch in ``hinm_spmm.launches``."""
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
            or kn != k // cfg.m * cfg.n or v % 8 or v > 128 or 512 % cfg.m):
        raise ValueError(
            f"hinm_spmm: unsupported shapes x {tuple(x.shape)}, vals "
            f"{tuple(p.vals.shape)}, vec_idx {tuple(p.vec_idx.shape)}, "
            f"{cfg.n}:{cfg.m} (V must be a multiple of 8 up to 128)")
    x = x.contiguous()
    b = x.shape[0]
    y = torch.empty((b, p.n_out), dtype=x.dtype, device=x.device)
    if b == 0:
        return y
    status = _launcher()(
        x.data_ptr(), p.vals.data_ptr(), p.nm_idx.data_ptr(),
        p.vec_idx.data_ptr(), y.data_ptr(), b, p.n_in, t, v, k, kn, cfg.n,
        cfg.m, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "hinm_spmm")
    hinm_spmm.launches += 1
    return y


hinm_spmm.launches = 0
