"""Decoder-only transformer (port of `repro.models.transformer`, dense family).

One `Block` module per layer in an `nn.ModuleList`, run by a Python loop —
this replaces the reference's `lax.scan` over layer-stacked params.  The
decode cache keeps the reference's layer-stacked layout (leaves of shape
``(L, ...)``); each layer works on its ``[i]`` views, so its cache writes
land in place in the stacked tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.types import PackedHiNM
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import paging
from repro_torch.models.module import PruneSpec

# pure-attention prefill: padded rows are exactly masked (sentinel kpos),
# so prompts can be bucketed to power-of-two lengths (serve admission)
BUCKETED_PREFILL = True


class Block(nn.Module):
    def __init__(self, ln1: M.Norm, attn: L.Attention, ln2: M.Norm, mlp: L.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp

    def forward(self, x, positions, cfg, cache=None, backend: str = "auto",
                spec: bool = False, variant: str | None = None):
        x = x + L.attention(self.attn, L.norm(self.ln1, x, cfg), positions, cfg,
                            cache, backend=backend, spec=spec, variant=variant)
        return x + L.mlp(self.mlp, L.norm(self.ln2, x, cfg), cfg, backend, variant)


class Transformer(nn.Module):
    def __init__(self, embed: M.Embed, blocks: list[Block], ln_f: M.Norm,
                 lm_head: M.Linear):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f
        self.lm_head = lm_head


def init_block(cfg, *, generator, device) -> Block:
    kw = dict(generator=generator, device=device)
    return Block(L.norm_init(cfg, device=device), L.attention_init(cfg, **kw),
                 L.norm_init(cfg, device=device), L.mlp_init(cfg, **kw))


def init(cfg, generator: torch.Generator | None = None, device="cuda") -> Transformer:
    """Random weights from `generator` (seeded by the caller).  Like the
    reference, a separate `lm_head` is built even when `tie_embeddings`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device)
    blocks = [init_block(cfg, **kw) for _ in range(cfg.n_layers)]
    return Transformer(
        M.embed_init(cfg.vocab_padded, cfg.d_model, cfg.dtype, **kw),
        blocks,
        L.norm_init(cfg, device=device),
        M.dense_init(cfg.d_model, cfg.vocab_padded, cfg.dtype, **kw),
    )


def _layer_cache(cache: dict, i: int) -> dict:
    return {k: v[i] for k, v in cache.items()}


def _run_blocks(model, cfg, x, positions, cache=None, backend="auto", spec=False,
                variant=None):
    for i, blk in enumerate(model.blocks):
        x = blk(x, positions, cfg, None if cache is None else _layer_cache(cache, i),
                backend, spec, variant)
    return x


def forward(model: Transformer, cfg, tokens: torch.Tensor, backend: str = "auto"):
    """Eval forward: pre-logits (B, S, D) (the loss projects vocab chunked)."""
    x = M.embed(model.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x = _run_blocks(model, cfg, x, positions, backend=backend)
    return L.norm(model.ln_f, x, cfg)


def logits_fn(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    return M.linear(model.lm_head, x)


def make_cache(cfg, batch: int, max_seq: int, dtype=None, page=None,
               n_pages=None, device="cuda") -> dict:
    """Decode cache with per-slot positions (continuous batching): stripes
    ``(L, B, max_seq, ...)``, or with ``page``/``n_pages`` the shared page
    pools ``(L, n_pages, page, ...)`` plus per-slot block tables."""
    dtype = dtype or cfg.dtype
    nl = cfg.n_layers
    if page is not None:
        geom = page_geometry(cfg, max_seq, page)
        kv = paging.make_attn_pool(nl, n_pages, geom["page"], cfg.n_kv_heads,
                                   cfg.head_dim, dtype, device)
        kv["pos"] = torch.zeros((nl, batch), dtype=torch.int32, device=device)
        kv.update(paging.make_tables(nl, batch, geom["n_bt"], device))
        return kv
    shape = (nl, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((nl, batch), dtype=torch.int32, device=device),
        "kpos": torch.full((nl, batch, max_seq), paging.KPOS_SENTINEL,
                           dtype=torch.int32, device=device),
    }


def page_geometry(cfg, max_seq: int, page: int) -> dict:
    """Paged-pool geometry: the full `max_seq` view is block-allocated."""
    return paging.geometry(max_seq, page)


def paged_insert(cfg, pool, stripe, slot, row, scatter_ids, bt_row, n_alloc):
    """Insert row `row` of a prefilled stripe cache into paged-pool slot
    `slot` whose pages are `scatter_ids`/`bt_row` (in place)."""
    return paging.insert_attn(pool, stripe, row, scatter_ids, bt_row, n_alloc, slot)


def paged_release(cfg, pool, slot, page_ids):
    return paging.release_attn(pool, page_ids, slot)


def prefill(model, cfg, tokens, cache, n_rows=None, backend: str = "auto"):
    """Fill the stripe cache in place; returns last-token pre-logits (B, D).

    `n_rows` (B,) enables bucketed prefill: rows past a lane's true length
    are padding whose positions (hence cached `kpos`) are the mask sentinel,
    and decode resumes at each lane's true length."""
    x = M.embed(model.embed, tokens)
    b, s, _ = x.shape
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    if n_rows is None:
        positions = ar.expand(b, s)
    else:
        positions = torch.where(ar[None, :] < n_rows[:, None], ar[None, :],
                                paging.KPOS_SENTINEL).to(torch.int32)
    x = _run_blocks(model, cfg, x, positions, cache, backend)
    x = L.norm(model.ln_f, x, cfg)
    if n_rows is None:
        return x[:, -1]
    cache["pos"][:] = n_rows.to(torch.int32)[None, :]
    return x[torch.arange(b, device=x.device), (n_rows - 1).long()]


def decode_step(model, cfg, tokens, cache, backend: str = "auto"):
    """One decode step. tokens (B, 1); returns logits (B, vocab_padded) and
    advances the cache in place."""
    x = M.embed(model.embed, tokens)
    # a copy: every layer advances its `pos` view in place
    positions = cache["pos"][0].clone()[:, None]            # (B, 1) per slot
    x = _run_blocks(model, cfg, x, positions, cache, backend)
    x = L.norm(model.ln_f, x, cfg)
    return logits_fn(model, x[:, 0])


# serve/spec: one parallel forward verifies all candidate rows (attention
# is the only stateful block, and its causal mask makes the multi-token
# write equivalent to sequential steps on non-windowed caches)
SPEC_VERIFY = "parallel"


def cache_position(cfg, cache) -> torch.Tensor:
    """Per-slot cache write position (B,) int32, a copy (the cache's own
    counters advance in place)."""
    return cache["pos"][0].clone()


def _decode_variant(model, b: int, x: torch.Tensor) -> str | None:
    """The K1 variant a decode step over `b` slots runs, for CUDA tensors
    of packed weights (None elsewhere: the plain versions take no variant,
    and a dense weight is a plain matmul)."""
    w = model.blocks[0].mlp.wd.w
    if x.device.type != "cuda" or not isinstance(w, PackedHiNM):
        return None
    from repro_torch.kernels import hinm_spmm

    return hinm_spmm.variant(b, w, x.dtype)


def verify_step(model, cfg, tokens, cache, backend: str = "auto"):
    """Speculative verify: one forward over ``tokens (B, S)`` — the pending
    token plus S-1 draft candidates per slot — writing all S cache rows in
    place through the decode write path.  Returns (logits (B, S,
    vocab_padded), undo); undo is None (a parallel verifier sweeps the
    rejected rows, `cache_rollback`).

    Row i's logits are meant to be bitwise decode step i's, so that a
    speculative stream is the non-speculative one: the packed projections
    run the K1 variant decode runs for the B slots ("rows" sums every
    output element in an order that does not depend on the batch) and K2
    takes decode's split plan.  The dense vocab projection is one matmul
    over all B * S rows; chip_smoke checks on the card that its rows come
    out bitwise as at decode's B rows."""
    b, s = tokens.shape
    x = M.embed(model.embed, tokens)
    positions = (cache["pos"][0][:, None]
                 + torch.arange(s, dtype=torch.int32, device=x.device)[None, :])
    x = _run_blocks(model, cfg, x, positions, cache, backend, spec=True,
                    variant=_decode_variant(model, b, x))
    x = L.norm(model.ln_f, x, cfg)
    return logits_fn(model, x), None


def cache_rollback(cfg, cache, undo, pos0, keep, n_written):
    """Keep ``keep (B,)`` of the ``n_written`` speculative rows per slot, in
    place: sweep the rejected suffix's kpos to the sentinel and rewind
    every layer's pos to ``pos0 + keep``."""
    if paging.is_paged(cache):
        return paging.rollback_attn_paged(cache, pos0, keep, n_written,
                                          window=bool(cfg.window))
    return paging.rollback_attn_stripe(cache, pos0, keep, n_written,
                                       window=bool(cfg.window))


def hinm_plan(cfg) -> list[PruneSpec]:
    """Prunable projections per layer (paper: attention + FFN linears)."""
    specs = [
        PruneSpec("attn/wq", can_permute_rows=False),
        PruneSpec("attn/wk", can_permute_rows=False),
        PruneSpec("attn/wv", row_blocks=cfg.n_kv_heads, consumers=("attn/wo:gqa",)),
        PruneSpec("attn/wo", can_permute_rows=False),
    ]
    if cfg.act == "swiglu":
        specs += [
            PruneSpec("mlp/wg", tied=("mlp/wu",), consumers=("mlp/wd",)),
            PruneSpec("mlp/wd", can_permute_rows=False),
        ]
    else:
        specs += [
            PruneSpec("mlp/wu", consumers=("mlp/wd",)),
            PruneSpec("mlp/wd", can_permute_rows=False),
        ]
    return specs
