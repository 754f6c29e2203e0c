"""Shared transformer layers (port of `repro.models.layers`): RoPE, GQA
attention with a chunked online softmax, the stripe and paged cache
branches, and the MLP.

Cache writes happen in place on the per-layer views of the stacked cache
tensors, where the reference returned updated arrays from a jit that
donated its buffers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import perf_knobs
from repro_torch.distributed import collectives
from repro_torch.kernels import ops as kops
from repro_torch.models import module as M
from repro_torch.models import paging

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) -> rotated x."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                   # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x32a, x32b = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x32a * cos - x32b * sin, x32b * cos + x32a * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention — chunked online softmax (flash-style in plain torch)
# ---------------------------------------------------------------------------


def _seq_parallel_decode_attn(q, ck, cv, q_pos, kpos, window: int, ctx) -> torch.Tensor:
    """Sequence-parallel decode attention (the reference's
    `_seq_parallel_decode_attn`): the stripe's sequence axis is split over
    'model'; each rank scores its own slice of the cache (``ck``/``cv``
    (B, S_local, KV, hd), ``kpos`` (B, S_local)) and the ranks combine the
    running max (all-reduce MAX) and the sums ``l`` and ``o`` (all-reduce
    SUM), O(B * H * hd) values instead of the cache.  On one rank it is
    `_attn_qchunk` over a single KV block, bit for bit."""
    ctx.note("seq_parallel_decode")
    b, sq, h, hd = q.shape
    kv = ck.shape[2]
    qf = (q.float() * hd ** -0.5).reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum("bqkgd,bckd->bqkgc", qf, ck.float())       # (B,1,KV,G,S_loc)
    msk = kpos[:, None, :] <= q_pos[:, :, None]
    if window:
        msk = msk & (kpos[:, None, :] > (q_pos[:, :, None] - window))
    s = torch.where(msk[:, :, None, None, :], s, NEG_INF)
    m = collectives.all_reduce(s.amax(dim=-1), ctx.mesh, "model", op=dist.ReduceOp.MAX)
    p = torch.exp(s - m[..., None])
    l = collectives.all_reduce(p.sum(dim=-1), ctx.mesh, "model")
    o = collectives.all_reduce(torch.einsum("bqkgc,bckd->bqkgd", p, cv.float()),
                               ctx.mesh, "model")
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _seq_sharded_stripe(q, k, v, positions, cache, cfg, ctx, kv_block: int) -> torch.Tensor:
    """A stripe layer whose K/V hold this rank's slice of the sequence
    (S_local rows of S = S_local * n_model; ``kpos`` whole): the decode
    step's new row lands on the rank that owns its position, then the
    attention is sequence-parallel (`KNOBS.seq_parallel_decode`), or over
    the gathered stripe."""
    pos = cache["pos"]
    ck, cv, ckpos = cache["k"], cache["v"], cache["kpos"]
    b, s = positions.shape
    s_loc, s_all = ck.shape[1], ckpos.shape[1]
    m, _ = collectives.axis_rank(ctx.mesh, "model")
    if s != 1:
        raise ValueError(f"a sequence-sharded stripe takes one decode row a step, not {s}")
    slot = torch.remainder(pos, s_all) if cfg.window else pos
    start = torch.clamp(slot, 0, s_all - s)
    idx = (start[:, None] + torch.arange(s, device=q.device)[None, :]).long()
    bidx = torch.arange(b, device=q.device)[:, None]
    ckpos[bidx, idx] = positions.to(torch.int32)
    loc = idx - m * s_loc
    mine = (loc >= 0) & (loc < s_loc)
    loc = torch.clamp(loc, 0, s_loc - 1)
    for leaf, new in ((ck, k), (cv, v)):
        keep = leaf[bidx, loc]
        leaf[bidx, loc] = torch.where(mine[..., None, None], new.to(leaf.dtype), keep)
    kpos_loc = ckpos[:, m * s_loc:(m + 1) * s_loc]
    if perf_knobs.KNOBS.seq_parallel_decode:
        return _seq_parallel_decode_attn(q, ck, cv, positions, kpos_loc, cfg.window, ctx)
    fk = collectives.gather_cat(ck, ctx.mesh, "model", dim=1)
    fv = collectives.gather_cat(cv, ctx.mesh, "model", dim=1)
    return _attn_chunked(q, fk, fv, positions, ckpos, True, cfg.window, kv_block)


def _attn_qchunk(qf, kb, vb, q_pos, pb, causal: bool, window: int) -> torch.Tensor:
    """Online softmax over KV blocks for one query chunk.
    qf (B, Sq, KV, G, hd) f32 pre-scaled; kb/vb (B, nblk, blk, KV, hd);
    q_pos (B, Sq); pb (B, nblk, blk)."""
    b, sq, kv, g, hd = qf.shape
    m = torch.full((b, sq, kv, g), NEG_INF, dtype=torch.float32, device=qf.device)
    l = torch.zeros((b, sq, kv, g), dtype=torch.float32, device=qf.device)
    o = torch.zeros((b, sq, kv, g, hd), dtype=torch.float32, device=qf.device)
    for i in range(kb.shape[1]):
        kc = kb[:, i].float()                                  # per-block upcast only
        vc = vb[:, i].float()
        pc = pb[:, i]
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kc)          # (B,Sq,KV,G,blk)
        if causal:
            msk = pc[:, None, :] <= q_pos[:, :, None]
        else:
            msk = torch.ones((b, sq, pc.shape[-1]), dtype=torch.bool, device=qf.device)
        if window:
            msk = msk & (pc[:, None, :] > (q_pos[:, :, None] - window))
        s = torch.where(msk[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vc)
        m = m_new
    return o / torch.clamp(l[..., None], min=1e-30)


def _attn_chunked(
    q: torch.Tensor,         # (B, Sq, H, hd)
    k: torch.Tensor,         # (B, Sk, KV, hd)
    v: torch.Tensor,         # (B, Sk, KV, hd)
    q_pos: torch.Tensor,     # (B, Sq) absolute positions of queries
    k_pos: torch.Tensor,     # (B, Sk) absolute positions of keys
    causal: bool,
    window: int,             # 0 = unlimited
    kv_block: int = 512,
    q_block: int = 512,
    aligned: bool = False,   # q_pos/k_pos are the standard arange (training)
) -> torch.Tensor:
    """Flash-style attention in plain torch: a loop over query blocks, an
    online softmax over KV blocks inside — peak memory is one (qblk, kvblk)
    score tile, never (S, S).  Blocking follows the reference exactly.

    With more than one query chunk and autograd on, each chunk is
    checkpointed, so the backward pass recomputes a chunk's probabilities
    instead of keeping them.  Under ``KNOBS.causal_block_skip`` a causal,
    `aligned` call gives query chunk i only the static run of KV blocks
    its mask reaches: from the window's first block to the diagonal's."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = (q.float() * hd ** -0.5).reshape(b, sq, kv, g, hd)
    nblk = max(1, sk // kv_block)
    if sk % kv_block != 0:
        nblk, kv_block = 1, sk
    kb = k.reshape(b, nblk, kv_block, kv, hd)   # stays in storage dtype;
    vb = v.reshape(b, nblk, kv_block, kv, hd)   # upcast happens per block
    pb = k_pos.reshape(b, nblk, kv_block)
    nq = max(1, sq // q_block)
    if sq % q_block != 0:
        nq, q_block = 1, sq
    if nq == 1:
        return _attn_qchunk(qf, kb, vb, q_pos, pb, causal, window).reshape(
            b, sq, h, hd).to(q.dtype)
    skip = causal and aligned and perf_knobs.KNOBS.causal_block_skip
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(nq):
        lo, hi = 0, nblk
        if skip:
            hi = min(nblk, ((i + 1) * q_block + kv_block - 1) // kv_block)
            if window:
                lo = max(0, (i * q_block - window) // kv_block)
        args = (qf[:, i * q_block:(i + 1) * q_block], kb, vb,
                q_pos[:, i * q_block:(i + 1) * q_block], pb, lo, hi, causal, window)
        outs.append(checkpoint(_attn_qchunk_blocks, *args, use_reentrant=False) if remat
                    else _attn_qchunk_blocks(*args))
    return torch.cat(outs, dim=1).reshape(b, sq, h, hd).to(q.dtype)


def _attn_qchunk_blocks(qf, kb, vb, q_pos, pb, lo: int, hi: int, causal: bool,
                        window: int) -> torch.Tensor:
    """`_attn_qchunk` over KV blocks lo..hi-1, sliced inside the checkpointed
    region: what the backward keeps is the one shared K/V, not a copy of
    each chunk's slice."""
    return _attn_qchunk(qf, kb[:, lo:hi], vb[:, lo:hi], q_pos, pb[:, lo:hi], causal, window)


def _seq_sharded():
    """The current mesh context if this step's stripes are sequence-sharded."""
    ctx = collectives.current()
    return ctx if ctx is not None and ctx.seq_sharded else None


class Attention(nn.Module):
    def __init__(self, wq: M.Linear, wk: M.Linear, wv: M.Linear, wo: M.Linear):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def attention_init(cfg, *, generator, device, d_in: int | None = None) -> Attention:
    d = d_in or cfg.d_model
    kw = dict(generator=generator, device=device)
    return Attention(
        M.dense_init(d, cfg.attn_out_dim, cfg.dtype, bias=cfg.qkv_bias, **kw),
        M.dense_init(d, cfg.kv_out_dim, cfg.dtype, bias=cfg.qkv_bias, **kw),
        M.dense_init(d, cfg.kv_out_dim, cfg.dtype, bias=cfg.qkv_bias, **kw),
        M.dense_init(cfg.attn_out_dim, cfg.d_model, cfg.dtype, **kw),
    )


def attention(
    p: Attention,
    x: torch.Tensor,              # (B, S, D)
    positions: torch.Tensor,      # (B, S)
    cfg,
    cache: dict | None = None,    # one layer's views of the stacked cache
    kv_block: int = 1024,
    backend: str = "auto",
    spec: bool = False,           # multi-token speculative verify write
    variant: str | None = None,   # K1 variant of the packed projections
    bidirectional: bool = False,  # no causal mask (an encoder; no cache)
) -> torch.Tensor:
    """GQA attention with RoPE.  Returns out (B, S, D); a cache, if given,
    is updated in place (its ``pos`` advances by S)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = M.linear(p.wq, x, backend, variant).reshape(b, s, h, hd)
    k = M.linear(p.wk, x, backend, variant).reshape(b, s, kvh, hd)
    v = M.linear(p.wv, x, backend, variant).reshape(b, s, kvh, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = _attn_chunked(q, k, v, positions, positions, not bidirectional, cfg.window,
                            kv_block, aligned=not bidirectional)
    elif paging.is_paged(cache):
        # Paged pool: the slot's rows live in shared physical pages resolved
        # through its block table.  The s new rows (one at decode, k+1 in a
        # speculative verify) are written straight to their physical pages
        # — rows outside the slot's allocation, and every row of an idle
        # lane, go to the scratch page — then the paged-attention kernel
        # walks the block table with the causal mask over the s rows.
        pos, bt, alloc = cache["pos"], cache["bt"], cache["alloc"]
        page = cache["k"].shape[1]                          # (n_pages, page, KV, hd)
        phys_s, off, valid = paging.spec_row_locations(
            bt, alloc, pos, s, page, window=bool(cfg.window))
        phys_w = torch.where(valid, phys_s, paging.SCRATCH_PAGE).long()
        off = off.long()
        ck, cv, ckpos = cache["k"], cache["v"], cache["kpos"]
        ck[phys_w, off] = k.to(ck.dtype)
        cv[phys_w, off] = v.to(cv.dtype)
        ckpos[phys_w, off] = positions.to(torch.int32)
        out = kops.paged_attention(q, ck, cv, ckpos, bt, positions.to(torch.int32),
                                   window=cfg.window, backend=backend)
        pos += s
    elif _seq_sharded():
        out = _seq_sharded_stripe(q, k, v, positions, cache, cfg, _seq_sharded(), kv_block)
        cache["pos"] += s
    else:
        # Stripe cache: per-slot absolute positions ("kpos") drive the
        # causal/window mask; every lane writes at its own offset (clamped
        # so the s rows fit, as dynamic_update_slice clamps).
        pos = cache["pos"]                                  # (B,) int32
        ck, cv, ckpos = cache["k"], cache["v"], cache["kpos"]
        smax = ck.shape[1]
        if s >= smax:
            # prefill as long as the cache: attend over the fresh K/V and
            # keep the trailing `smax` rows, rolled so slot == pos % smax
            out = _attn_chunked(q, k, v, positions, positions, True, cfg.window,
                                kv_block)
            # (a gather by per-lane index, no host read: it captures in a
            # CUDA graph)
            shift = torch.remainder(positions[:, -smax].to(torch.int64), smax)
            src = torch.remainder(torch.arange(smax, device=x.device)[None, :]
                                  - shift[:, None], smax)
            for leaf, new in ((ck, k), (cv, v), (ckpos, positions)):
                tail = new[:, -smax:]
                idx = src.reshape((b, smax) + (1,) * (tail.dim() - 2)).expand(tail.shape)
                leaf.copy_(torch.gather(tail, 1, idx).to(leaf.dtype))
        else:
            bidx = torch.arange(b, device=x.device)[:, None]
            if spec and s > 1:
                # speculative verify: the s rows at each lane's own offsets;
                # rows past the stripe end are dropped, as the reference's
                # scatter drops them (over-reservation rows the acceptance
                # cap rejects) — they land in a spare row
                if cfg.window:
                    raise ValueError("a multi-token verify write cannot wrap a "
                                     "windowed ring")
                idx = pos.long()[:, None] + torch.arange(s, device=x.device)[None, :]
                idx = torch.where(idx < smax, idx, smax)
                spare = (b, 1) + tuple(ck.shape[2:])
                for name, new in (("k", k), ("v", v), ("kpos", positions)):
                    leaf = cache[name]
                    pad = torch.cat([leaf, leaf.new_zeros(spare[: leaf.dim()])], dim=1)
                    pad[bidx, idx] = new.to(leaf.dtype)
                    leaf.copy_(pad[:, :smax])
            else:
                slot = torch.remainder(pos, smax) if cfg.window else pos
                start = torch.clamp(slot, 0, smax - s)
                idx = (start[:, None] + torch.arange(s, device=x.device)[None, :]).long()
                ck[bidx, idx] = k.to(ck.dtype)
                cv[bidx, idx] = v.to(cv.dtype)
                ckpos[bidx, idx] = positions.to(torch.int32)
            out = _attn_chunked(q, ck, cv, positions, ckpos, True, cfg.window,
                                kv_block)
        pos += s
    return M.linear(p.wo, out.reshape(b, s, h * hd), backend, variant)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, **lins: M.Linear):
        super().__init__()
        for name, lin in lins.items():
            setattr(self, name, lin)


def mlp_init(cfg, *, generator, device, d_ff: int | None = None) -> MLP:
    f = d_ff or cfg.d_ff
    kw = dict(generator=generator, device=device)
    if cfg.act == "swiglu":
        return MLP(wg=M.dense_init(cfg.d_model, f, cfg.dtype, **kw),
                   wu=M.dense_init(cfg.d_model, f, cfg.dtype, **kw),
                   wd=M.dense_init(f, cfg.d_model, cfg.dtype, **kw))
    return MLP(wu=M.dense_init(cfg.d_model, f, cfg.dtype, bias=True, **kw),
               wd=M.dense_init(f, cfg.d_model, cfg.dtype, bias=True, **kw))


def mlp(p: MLP, x: torch.Tensor, cfg, backend: str = "auto",
        variant: str | None = None) -> torch.Tensor:
    if cfg.act == "swiglu":
        gate = F.silu(M.linear(p.wg, x, backend, variant).float())
        up = M.linear(p.wu, x, backend, variant).float()
        return M.linear(p.wd, (gate * up).to(x.dtype), backend, variant)
    hid = F.gelu(M.linear(p.wu, x, backend, variant).float(), approximate="tanh")
    return M.linear(p.wd, hid.to(x.dtype), backend, variant)


def norm_init(cfg, *, device, d: int | None = None) -> M.Norm:
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return M.rmsnorm_init(d, cfg.dtype, device=device)
    return M.layernorm_init(d, cfg.dtype, device=device)


def norm(p: M.Norm, x: torch.Tensor, cfg) -> torch.Tensor:
    return M.rmsnorm(p, x) if cfg.norm == "rmsnorm" else M.layernorm(p, x)
