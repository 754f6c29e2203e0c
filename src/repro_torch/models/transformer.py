"""Decoder-only transformer (port of `repro.models.transformer`): the dense
family, the MoE family's backbone (a block's FFN is then `moe.MoE`) and the
vlm family's (frontend-stub embeddings placed before the tokens).

One `Block` module per layer in an `nn.ModuleList`, run by a Python loop —
this replaces the reference's `lax.scan` over layer-stacked params.  The
decode cache keeps the reference's layer-stacked layout (leaves of shape
``(L, ...)``); each layer works on its ``[i]`` views, so its cache writes
land in place in the stacked tensors.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.core.types import PackedHiNM
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import moe as MOE
from repro_torch.models import paging
from repro_torch.models.module import PruneSpec

# pure-attention prefill: padded rows are exactly masked (sentinel kpos),
# so prompts can be bucketed to power-of-two lengths (serve admission)
BUCKETED_PREFILL = True
# K/V rows are pure per-(token, position) projections here: an identical
# token prefix at identical positions caches identical rows, so physical
# pages can be refcount-shared across slots (serve/prefix)
PREFIX_SHARE = True


class Block(nn.Module):
    """Attention, then the FFN: ``mlp`` (dense family) or ``moe`` (MoE)."""

    def __init__(self, ln1: M.Norm, attn: L.Attention, ln2: M.Norm, mlp: L.MLP | None = None,
                 moe: MOE.MoE | None = None):
        super().__init__()
        self.ln1, self.attn, self.ln2 = ln1, attn, ln2
        if moe is None:
            self.mlp = mlp
        else:
            self.moe = moe

    def forward(self, x, positions, cfg, cache=None, backend: str = "auto",
                spec: bool = False, variant: str | None = None):
        x = x + L.attention(self.attn, L.norm(self.ln1, x, cfg), positions, cfg,
                            cache, backend=backend, spec=spec, variant=variant)
        h = L.norm(self.ln2, x, cfg)
        if cfg.family == "moe":
            return x + MOE.moe_apply(self.moe, h, cfg, backend=backend, variant=variant)
        return x + L.mlp(self.mlp, h, cfg, backend, variant)


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
    ln1, attn, ln2 = (L.norm_init(cfg, device=device), L.attention_init(cfg, **kw),
                      L.norm_init(cfg, device=device))
    if cfg.family == "moe":
        return Block(ln1, attn, ln2, moe=MOE.moe_init(cfg, **kw))
    return Block(ln1, attn, ln2, L.mlp_init(cfg, **kw))


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


def embed_inputs(model: Transformer, cfg, tokens: torch.Tensor,
                 embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embedding; `embeds` (B, P, D) is the modality-frontend stub
    (precomputed patch embeddings of a vlm config), cast to the model's
    dtype and placed before the tokens."""
    x = M.embed(model.embed, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def forward(model: Transformer, cfg, tokens: torch.Tensor, embeds=None,
            backend: str = "auto", remat: bool = False):
    """Training / eval forward: pre-logits (B, P + S, D) (the loss projects
    vocab chunked).  `remat` checkpoints each block (non-reentrant
    `torch.utils.checkpoint`): the backward recomputes a block's
    activations instead of keeping them, as the reference remats each layer
    of its scan."""
    x = embed_inputs(model, cfg, tokens, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    if remat:
        for blk in model.blocks:
            x = checkpoint(blk, x, positions, cfg, None, backend, use_reentrant=False)
    else:
        x = _run_blocks(model, cfg, x, positions, backend=backend)
    return L.norm(model.ln_f, x, cfg)


def _tree_of(mod: nn.Module) -> dict:
    """A module's tensors as a nested dict (a packed weight is not one)."""
    if any(isinstance(getattr(m, "w", None), PackedHiNM) for m in mod.modules()):
        raise ValueError("params_of takes a dense model; unpack_params first")
    out = dict(mod.named_buffers(recurse=False))
    for name, child in mod.named_children():
        out[name] = _tree_of(child)
    return out


def params_of(model: Transformer) -> dict:
    """The model's dense tensors as the reference's params tree: ``embed``,
    ``blocks`` (every leaf stacked over layers, ``(L, ...)``), ``ln_f``,
    ``lm_head`` — new tensors, the model's stay as they were."""
    tree = {name: T.map(torch.clone, _tree_of(child))
            for name, child in model.named_children() if name != "blocks"}
    per_block = [_tree_of(blk) for blk in model.blocks]
    tree["blocks"] = T.map(lambda *xs: torch.stack(xs), per_block[0], *per_block[1:])
    return tree


def from_params(cfg, params: dict) -> Transformer:
    """A model whose tensors are `params`' own: block i holds the layer-i
    views of the stacked leaves, so autograd through its forward reaches
    the tree's leaves, and nothing is copied."""
    # one unbind per stacked leaf: its backward stacks the layers' grads
    # once (indexing each layer would scatter into a zeroed full stack per
    # layer)
    blk = T.map(lambda t: t.unbind(0), params["blocks"])

    def lin(node, i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        b = node.get("b")
        return M.Linear(pick(node["w"]), None if b is None else pick(b))

    def norm(node, i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        bias = node.get("bias")
        return M.Norm(pick(node["scale"]), None if bias is None else pick(bias))

    def ffn(i):
        if "moe" in blk:
            return dict(moe=MOE.MoE(**{n: lin(blk["moe"][n], i)
                                       for n in ("router", "wg", "wu", "wd")}))
        return dict(mlp=L.MLP(**{n: lin(node, i) for n, node in blk["mlp"].items()}))

    blocks = [Block(norm(blk["ln1"], i),
                    L.Attention(*(lin(blk["attn"][n], i) for n in ("wq", "wk", "wv", "wo"))),
                    norm(blk["ln2"], i), **ffn(i))
              for i in range(cfg.n_layers)]
    return Transformer(M.Embed(params["embed"]["table"]), blocks,
                       norm(params["ln_f"]), lin(params["lm_head"]))


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


def reset_cache(cfg, cache) -> None:
    paging.reset_attn(cache)


def cache_batch_axes(cfg, cache) -> dict:
    """The slot axis of each cache leaf: 1 for the (L, B, ...) stripe and
    bookkeeping leaves, None for a paged pool's page buffers."""
    pooled = ("k", "v", "kpos") if paging.is_paged(cache) else ()
    return {name: None if name in pooled else 1 for name in cache}


def cache_shard_roles(cfg, cache) -> dict:
    """Sharding role per cache leaf: a paged pool shards its page axis, a
    stripe its slot axis."""
    if paging.is_paged(cache):
        return paging.paged_roles(cache)
    return {"k": "kv", "v": "kv", "pos": "slot", "kpos": "slot"}


def page_geometry(cfg, max_seq: int, page: int) -> dict:
    """Paged-pool geometry: the full `max_seq` view is block-allocated."""
    return paging.geometry(max_seq, page)


def paged_insert(cfg, pool, stripe, slot, row, scatter_ids, bt_row, n_alloc):
    """Insert row `row` of a prefilled stripe cache into paged-pool slot
    `slot` whose pages are `scatter_ids`/`bt_row` (in place)."""
    return paging.insert_attn(pool, stripe, row, scatter_ids, bt_row, n_alloc, slot)


def paged_release(cfg, pool, slot, page_ids):
    return paging.release_attn(pool, page_ids, slot)


def paged_map(cfg, pool, slot, bt_row, n_alloc, pos):
    """Map `slot` onto already-written pages (prefix sharing), in place:
    block table and counters only, no K/V moves."""
    return paging.map_attn(pool, bt_row, n_alloc, pos, slot)


def paged_copy_page(cfg, pool, dst, src, keep_rows):
    """Copy-on-write the divergent tail page (first `keep_rows` rows)."""
    return paging.copy_page(pool, dst, src, keep_rows)


def paged_sweep(cfg, pool, page_ids):
    """kpos-sentinel sweep of unreferenced pages (prefix-cache eviction)."""
    return paging.sweep_pages(pool, page_ids)


def prefill(model, cfg, tokens, cache, embeds=None, n_rows=None, backend: str = "auto"):
    """Fill the stripe cache in place; returns last-token pre-logits (B, D).

    `embeds` (B, P, D) go before the tokens (a vlm's patch rows), so a
    lane's cache rows are P + its prompt.  `n_rows` (B,) enables bucketed
    prefill: rows past a lane's true row count (embeds included) are
    padding whose positions (hence cached `kpos`) are the mask sentinel,
    and decode resumes at each lane's true row count."""
    x = embed_inputs(model, cfg, tokens, embeds)
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


def rewind_cache(cfg, cache) -> None:
    cache["pos"].zero_()


def _decode_variant(w, b: int, x: torch.Tensor) -> str | None:
    """The K1 variant a decode step over `b` slots runs against the planned
    weight `w`, for CUDA tensors of packed weights (None elsewhere: the
    plain versions take no variant, and a dense weight is a plain
    matmul)."""
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
    out bitwise as at decode's B rows.  An MoE block holds its experts to
    the variant decode's capacity gets (`moe.moe_apply`)."""
    b, s = tokens.shape
    x = M.embed(model.embed, tokens)
    positions = (cache["pos"][0][:, None]
                 + torch.arange(s, dtype=torch.int32, device=x.device)[None, :])
    x = _run_blocks(model, cfg, x, positions, cache, backend, spec=True,
                    variant=_decode_variant(model.blocks[0].attn.wo.w, b, x))
    x = L.norm(model.ln_f, x, cfg)
    return logits_fn(model, x), None


def extend_step(model, cfg, tokens, cache, backend: str = "auto"):
    """Extension prefill: forward ``tokens (B, C)`` from each slot's current
    position, writing all C cache rows in place through the multi-token
    decode write path `verify_step` takes.  Returns (pre-logits hidden
    states (B, C, D), undo None): the caller projects only the rows it
    samples from, and chunked or suffix prefill sweeps co-resident lanes'
    junk rows with `cache_rollback`, as after a rejected speculation.

    Unlike the verify, the packed projections run the K1 variant the
    dispatch picks for B * C rows (prefill's work, "mma" in bf16), so a
    row's bits depend on the extension's width, as a group prefill's do
    on its group's."""
    b, s = tokens.shape
    x = M.embed(model.embed, tokens)
    positions = (cache["pos"][0][:, None]
                 + torch.arange(s, dtype=torch.int32, device=x.device)[None, :])
    x = _run_blocks(model, cfg, x, positions, cache, backend, spec=True)
    return L.norm(model.ln_f, x, cfg), None


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
    # an MoE block's expert stacks take the FFN's places; each of their
    # items searches its experts in turn
    prefix = "moe" if cfg.family == "moe" else "mlp"
    if cfg.act == "swiglu":
        specs += [
            PruneSpec(f"{prefix}/wg", tied=(f"{prefix}/wu",), consumers=(f"{prefix}/wd",)),
            PruneSpec(f"{prefix}/wd", can_permute_rows=False),
        ]
    else:
        specs += [
            PruneSpec(f"{prefix}/wu", consumers=(f"{prefix}/wd",)),
            PruneSpec(f"{prefix}/wd", can_permute_rows=False),
        ]
    return specs
