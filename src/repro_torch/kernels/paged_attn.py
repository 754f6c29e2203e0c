"""Paged-KV decode attention: the CUDA kernel's wrapper and its plain version.

Port of `repro.kernels.paged_attn` (the TPU kernel `paged_decode_attn` /
`_kernel`).  The kernel (`src/repro_torch/csrc/paged_attn.cu`) replaces the
TPU kernel's sequential walk over a slot's block table with flash-decoding:
the table is cut into contiguous splits, one block per (split, KV head,
slot) with all of its pages in flight at once, and a second small kernel
combines the splits' (m, l, acc) partials exactly.  It is bound by latency
(a launch and two dependent DRAM round trips), not by its few hundred KB;
the first design lost to it by walking the table page by page in 8
blocks.  `plan_splits` picks the number of splits from the shapes alone,
so a captured CUDA graph stays valid whatever the table holds, and gives
an s-row speculative verify the splits of single-row decode: with the
kernel's per-row order fixed by one query's rows, verify row i is then
bitwise decode step i.  The plain
version, `paged_decode_attn_ref`, is exactly the reference the JAX tests
hold the TPU kernel to: `paging.gather_view` + `layers._attn_chunked`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None

SMEM_MAX = 232_448     # shared memory one block may use on the H100 (227 KB)
TARGET_BLOCKS = 64     # blocks a call aims at (chip_smoke's K2 split sweep)
MAX_SPLIT_PAGES = 8    # table entries one block takes at most


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("paged_attn").paged_attn_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _smem_bytes(gs: int, hd: int, page: int, pages: int, itemsize: int) -> int:
    """Shared memory of the split kernel for splits of up to `pages` pages:
    csrc/paged_attn.cu:smem_bytes with K and V rows padded by its largest
    pad, 16 bytes."""
    keys = pages * page
    head = 4 * (gs * hd + gs * keys + 2 * gs) + 4 * (keys + gs + pages)
    return -(-head // 16) * 16 + 2 * keys * (hd * itemsize + 16)


@functools.lru_cache(maxsize=None)
def split_count(b: int, kvh: int, n_bt: int, gs: int, page: int, hd: int,
                itemsize: int) -> int:
    """Splits of each slot's block table: enough blocks to fill the card
    (TARGET_BLOCKS over the B * KV (slot, head) pairs), at most
    MAX_SPLIT_PAGES pages and what fits in shared memory per split, never
    more splits than table entries.  Shapes only, never the table's
    contents.  Raises where one page's K and V do not fit a block."""
    pages = next((n for n in range(MAX_SPLIT_PAGES, 0, -1)
                  if _smem_bytes(gs, hd, page, n, itemsize) <= SMEM_MAX), 0)
    if not pages:
        raise ValueError(f"paged_decode_attn: one page of {page} rows x hd {hd} "
                         f"({itemsize}-byte) with {gs} query rows exceeds a block's "
                         f"{SMEM_MAX} bytes of shared memory")
    return min(n_bt, max(-(-n_bt // pages), -(-TARGET_BLOCKS // (b * kvh))))


@functools.lru_cache(maxsize=None)
def plan_splits(b: int, kvh: int, n_bt: int, g: int, s: int, page: int, hd: int,
                itemsize: int) -> int:
    """The split count a call of s query rows per slot runs: the s = 1
    plan's (`split_count` at g rows), so that a speculative verify's row i
    is summed over the same splits, in the same order, as the i-th
    single-row decode step; the s-row plan only where the s = 1 plan's
    splits do not fit shared memory at s * g rows."""
    n = split_count(b, kvh, n_bt, g, page, hd, itemsize)
    if s == 1 or _smem_bytes(s * g, hd, page, -(-n_bt // n), itemsize) <= SMEM_MAX:
        return n
    return split_count(b, kvh, n_bt, s * g, page, hd, itemsize)


def split_ranges(n_bt: int, n_splits: int) -> list[tuple[int, int]]:
    """Table entries [start, stop) of each split, as the kernel cuts them."""
    return [(i * n_bt // n_splits, (i + 1) * n_bt // n_splits) for i in range(n_splits)]


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
    """Block-table-resolved decode attention through the CUDA kernel (the
    split kernel, then the combine where there is more than one split).
    Returns (B, s, H, hd) in q's dtype; counts one launch per call in
    ``paged_decode_attn.launches`` and records the split count that
    `plan_splits` picked in ``paged_decode_attn.last_splits``."""
    out, paged_decode_attn.last_splits = _launch(q, k_pool, v_pool, kpos_pool, bt,
                                                 q_pos, window)
    paged_decode_attn.launches += 1
    return out


def _launch(q, k_pool, v_pool, kpos_pool, bt, q_pos, window, n_splits=None):
    """Check the arguments, allocate the workspace and launch the kernels
    with `n_splits` splits (`plan_splits`'s plan where None).  Returns the
    output and the split count it ran."""
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
    gs = s * (h // kvh)
    if n_splits is None:
        n_splits = plan_splits(b, kvh, n_bt, h // kvh, s, page, hd, q.element_size())
    elif not 1 <= n_splits <= n_bt:
        raise ValueError(f"paged_decode_attn: n_splits {n_splits} outside [1, n_bt {n_bt}]")
    out = torch.empty_like(q)
    # the splits' (acc, m, l) partials; none with one split
    ws = (torch.empty(b * kvh * n_splits * gs * (hd + 2), dtype=torch.float32,
                      device=q.device) if n_splits > 1 else None)
    status = _launcher()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), kpos_pool.data_ptr(),
        bt.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, s, h, kvh, hd, page, n_bt,
        n_splits, int(window), hd ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "paged_decode_attn")
    return out, n_splits


paged_decode_attn.launches = 0
paged_decode_attn.last_splits = None
