"""Paged-KV decode attention: the CUDA kernel's wrapper and its plain version.

Port of `repro.kernels.paged_attn` (the TPU kernel `paged_decode_attn` /
`_kernel`).  The kernel (`src/repro_torch/csrc/paged_attn.cu`, design and
bound noted there) walks each slot's block table page by page with an
online softmax and never builds the gathered view.  Its plain version,
`paged_decode_attn_ref`, is exactly the reference the JAX tests hold the
TPU kernel to: `paging.gather_view` + `layers._attn_chunked`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("paged_attn").paged_attn_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_decode_attn_ref(q, k_pool, v_pool, kpos_pool, bt, q_pos, *,
                          window: int = 0) -> torch.Tensor:
    """Gather the slots' logical views through `bt`, then chunked attention."""
    from repro_torch.models import layers, paging

    k_view = paging.gather_view(k_pool, bt)
    v_view = paging.gather_view(v_pool, bt)
    p_view = paging.gather_view(kpos_pool, bt)
    return layers._attn_chunked(q, k_view, v_view, q_pos, p_view, True,
                                window, 1024)


def paged_decode_attn(
    q: torch.Tensor,          # (B, s, H, hd) — s decode rows per slot
    k_pool: torch.Tensor,     # (n_pages, page, KV, hd)
    v_pool: torch.Tensor,     # (n_pages, page, KV, hd)
    kpos_pool: torch.Tensor,  # (n_pages, page) int32
    bt: torch.Tensor,         # (B, n_bt) int32 block table
    q_pos: torch.Tensor,      # (B, s) int32 absolute query positions
    *,
    window: int = 0,
) -> torch.Tensor:
    """Block-table-resolved decode attention through the CUDA kernel.
    Returns (B, s, H, hd) in q's dtype; counts one launch in
    ``paged_decode_attn.launches``."""
    b, s, h, hd = q.shape
    n_pages, page, kvh, hd2 = k_pool.shape
    n_bt = bt.shape[-1]
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attn: the CUDA kernel takes CUDA tensors, got {q.device}")
    args = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "kpos": kpos_pool,
            "bt": bt, "q_pos": q_pos}
    for name, a in args.items():
        if a.device != q.device:
            raise ValueError(f"paged_decode_attn: {name} on {a.device}, q on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"paged_decode_attn: {name} must be contiguous")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("paged_decode_attn: q and the pools must all be float32 "
                         "or all bfloat16")
    if (kpos_pool.dtype, bt.dtype, q_pos.dtype) != (torch.int32,) * 3:
        raise ValueError("paged_decode_attn: kpos, bt and q_pos must be int32")
    if (hd2 != hd or h % kvh or v_pool.shape != k_pool.shape
            or kpos_pool.shape != (n_pages, page) or bt.shape != (b, n_bt)
            or q_pos.shape != (b, s)):
        raise ValueError(
            f"paged_decode_attn: unsupported shapes q {tuple(q.shape)}, pool "
            f"{tuple(k_pool.shape)}, kpos {tuple(kpos_pool.shape)}, bt "
            f"{tuple(bt.shape)}, q_pos {tuple(q_pos.shape)}")
    out = torch.empty_like(q)
    status = _launcher()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), kpos_pool.data_ptr(),
        bt.data_ptr(), q_pos.data_ptr(), out.data_ptr(), b, s, h, kvh, hd, page,
        n_bt, int(window), hd ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "paged_decode_attn")
    paged_decode_attn.launches += 1
    return out


paged_decode_attn.launches = 0
