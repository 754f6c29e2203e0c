"""N:M magnitude select: the CUDA kernel's wrapper and its plain version.

Port of `repro.kernels.nm_select` (the TPU kernel `nm_select` / `_kernel`):
keep the top-N-of-each-M group along the last axis by |w|, ties to the
lower index, and write +0 elsewhere; kept values are copied bit for bit.
The kernel lives in `src/repro_torch/csrc/nm_select.cu` (design and bound
noted there); `nm_select_ref` is its plain version.  Only the public entry
point `ops.nm_apply` reaches it, as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import nm_select_ref

__all__ = ["nm_select", "nm_select_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_M = (2, 4, 8)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("nm_select").nm_select_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def nm_select(w: torch.Tensor, nn: int = 2, mm: int = 4) -> torch.Tensor:
    """Top-N-of-M select along the last axis of a 2-D CUDA tensor through
    the kernel; raises on anything it does not take.  Counts one launch in
    ``nm_select.launches``."""
    if w.device.type != "cuda":
        raise ValueError(f"nm_select: the CUDA kernel takes CUDA tensors, got {w.device}")
    if w.dim() != 2 or w.shape[1] % mm != 0:
        raise ValueError(f"nm_select: need a 2-D array with cols % M == 0, got "
                         f"{tuple(w.shape)} and M={mm}")
    if w.dtype not in _DTYPES:
        raise ValueError(f"nm_select: float32 or bfloat16, got {w.dtype}")
    if mm not in _KERNEL_M or not 0 < nn < mm:
        raise ValueError(f"nm_select: the kernel takes M in {_KERNEL_M} and "
                         f"0 < N < M, got {nn}:{mm}")
    w = w.contiguous()
    if w.data_ptr() % (mm * w.element_size()):
        w = w.clone()  # a fresh allocation is aligned for the vector loads
    out = torch.empty_like(w)
    if w.numel() == 0:
        return out
    status = _launcher()(w.data_ptr(), out.data_ptr(), w.numel() // mm, nn, mm,
                         _DTYPES[w.dtype], torch.cuda.current_stream(w.device).cuda_stream)
    build.check(status, "nm_select")
    nm_select.launches += 1
    return out


nm_select.launches = 0
