"""K2 `paged_decode_attn`: the idle lane against the Pallas kernel (interpret
mode), the CUDA kernel's split-and-combine arithmetic replayed in plain torch
against the plain version for every split count, and the split plan.

The CUDA kernel (src/repro_torch/csrc/paged_attn.cu) runs only on the card,
where chip_smoke.py holds it against the plain version, idle lanes included;
here its math and its plan are checked before the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import paging as jpaging
from repro_torch.convert import to_tensor
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as pa
from test_torch_kernels import CASES, _paged_case
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NEG_INF = -1e30
IDLE = 1  # the idle slot of _idle_case


def _idle_case(dtype):
    """Three slots, slot IDLE an idle lane: its whole table the sentinel
    page (whose V is random, like every page's) and its position 0, so every
    key it visits is masked."""
    jargs, _ = _paged_case(3, 1, 2, 2, 32, 8, 4, 16, dtype, seed=5)
    bt = np.asarray(jargs[4]).copy()
    q_pos = np.asarray(jargs[5]).copy()
    bt[IDLE] = jpaging.SENTINEL_PAGE
    q_pos[IDLE] = 0
    jargs = jargs[:4] + (jnp.asarray(bt), jnp.asarray(q_pos))
    return jargs, tuple(to_tensor(np.asarray(a), "cpu") for a in jargs)


def _sentinel_mean(v_pool, g):
    """The reference's answer on an idle lane: the mean of V over every
    visited entry — all of them the sentinel page — as (H, hd)."""
    mean = v_pool[jpaging.SENTINEL_PAGE].float().mean(0)        # (KV, hd)
    return mean.repeat_interleave(g, dim=0)


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-6), ("bfloat16", 5e-2)])
def test_idle_lane_matches_pallas(dtype, tol):
    jargs, targs = _idle_case(dtype)
    ref = np.asarray(jops.paged_attention(*jargs, backend="interpret").astype(jnp.float32))
    out = ops.paged_attention(*targs).float()
    assert np.abs(out.numpy() - ref).max() < tol
    want = _sentinel_mean(targs[2], 2)
    assert (out[IDLE, 0] - want).abs().max() < tol


def _split_combine(q, k_pool, v_pool, kpos, bt, q_pos, n_splits, window=0):
    """The CUDA kernel's arithmetic in plain torch: per split (its table
    entries as `split_ranges` cuts them) masked f32 scores with the finite
    NEG_INF, m = max, p = exp(s - m), l = sum p, acc = p @ V; then the one
    combine, M = max m_i, w_i = exp(m_i - M), out = sum w_i acc_i /
    max(sum w_i l_i, 1e-30).  GQA rows stacked s-major, as in the kernel."""
    b, s, h, hd = q.shape
    kvh = k_pool.shape[2]
    g = h // kvh
    qf = (q.float() * hd ** -0.5).reshape(b, s, kvh, g, hd).transpose(1, 2)
    qf = qf.reshape(b, kvh, s * g, hd)
    qp = q_pos.repeat_interleave(g, dim=1)                       # (B, Gs)
    ms, ls, accs = [], [], []
    for e0, e1 in pa.split_ranges(bt.shape[1], n_splits):
        pages = bt[:, e0:e1].long()
        k = k_pool[pages].float().reshape(b, -1, kvh, hd).transpose(1, 2)
        v = v_pool[pages].float().reshape(b, -1, kvh, hd).transpose(1, 2)
        kp = kpos[pages].reshape(b, 1, 1, -1)
        ok = kp <= qp[:, None, :, None]
        if window:
            ok &= kp > qp[:, None, :, None] - window
        sc = torch.where(ok, qf @ k.transpose(-1, -2), torch.tensor(NEG_INF))
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(p @ v)
    m_i = torch.stack(ms)
    w = torch.exp(m_i - m_i.amax(0))
    out = (w * torch.stack(accs)).sum(0) / (w * torch.stack(ls)).sum(0).clamp_min(1e-30)
    return out.reshape(b, kvh, s, g, hd).transpose(1, 2).reshape(b, s, h, hd)


def _f32(targs):
    return tuple(a.float() if a.is_floating_point() else a for a in targs)


@pytest.mark.parametrize("b,s,kvh,g,hd,page,n_bt,n_pages,window,dtype,tol", CASES)
def test_split_and_combine_matches_plain_for_every_split_count(
        b, s, kvh, g, hd, page, n_bt, n_pages, window, dtype, tol):
    _, targs = _paged_case(b, s, kvh, g, hd, page, n_bt, n_pages, dtype)
    targs = _f32(targs)
    ref = pa.paged_decode_attn_ref(*targs, window=window)
    for n in range(1, n_bt + 1):
        err = (_split_combine(*targs, n, window) - ref).abs().max()
        assert err < 5e-6, (n, err)


def test_split_and_combine_keeps_the_idle_lane():
    """Every split of an idle lane has m_i = NEG_INF, so every w_i = 1 and
    the combine gives the reference's mean of V, at every split count."""
    _, targs = _idle_case("float32")
    ref = pa.paged_decode_attn_ref(*targs)
    want = _sentinel_mean(targs[2], 2)
    for n in range(1, targs[4].shape[1] + 1):
        out = _split_combine(*targs, n)
        assert (out - ref).abs().max() < 5e-6, n
        assert (out[IDLE, 0] - want).abs().max() < 5e-6, n


def test_split_ranges_cover_every_entry_once():
    for n_bt in range(1, 41):
        for n in range(1, n_bt + 1):
            ranges = pa.split_ranges(n_bt, n)
            assert len(ranges) == n and all(hi > lo for lo, hi in ranges)
            assert [e for lo, hi in ranges for e in range(lo, hi)] == list(range(n_bt))


# (B, KV, n_bt, Gs, page, hd, itemsize)
PLANS = [
    (4, 2, 16, 7, 16, 64, 2),       # the served decode shape
    (4, 2, 16, 21, 16, 64, 2),      # speculative verify, s = 3
    (4, 2, 64, 7, 16, 64, 2),
    (4, 2, 256, 7, 16, 64, 2),      # long context
    (2, 4, 4096, 7, 16, 128, 4),
    (72, 2, 4, 7, 16, 64, 2),       # B * KV over the target: one split
    (1, 1, 1, 1, 4, 16, 4),
    (3, 2, 5, 6, 8, 18, 2),         # rows not 16-byte aligned
    (1, 1, 9, 64, 128, 128, 4),     # one page fills most of a block
]


@pytest.mark.parametrize("b,kvh,n_bt,gs,page,hd,isz", PLANS)
def test_split_plan_covers_the_table(b, kvh, n_bt, gs, page, hd, isz):
    n = pa.split_count(b, kvh, n_bt, gs, page, hd, isz)
    assert 1 <= n <= n_bt
    sizes = [hi - lo for lo, hi in pa.split_ranges(n_bt, n)]
    assert sum(sizes) == n_bt and min(sizes) >= 1
    assert max(sizes) <= pa.MAX_SPLIT_PAGES
    # the largest split's shared memory fits
    assert pa._smem_bytes(gs, hd, page, max(sizes), isz) <= pa.SMEM_MAX


def test_split_plan_at_the_served_shape():
    served = pa.split_count(4, 2, 16, 7, 16, 64, 2)
    assert 64 <= 4 * 2 * served <= 128            # the card filled, not 8 blocks
    assert pa.split_count(72, 2, 4, 7, 16, 64, 2) == 1
    with pytest.raises(ValueError, match="shared memory"):
        pa.split_count(1, 1, 4, 7, 1024, 256, 4)
