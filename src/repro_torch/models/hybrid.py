"""RecurrentGemma-style hybrid (port of `repro.models.hybrid`,
recurrentgemma-9b): pattern (rec, rec, attn) per period, each layer a
temporal mixer (an RG-LRU block, `rglru`, or local sliding-window
attention) plus an MLP (Griffin's residual block).

Layer i sits at pattern position i % len(pattern), in period
i // len(pattern).  The model keeps one `nn.ModuleList` a pattern
position, ``stack0``, ``stack1``, ``stack2``: the reference's
``stacks[j]`` with leaves stacked ``(n_j, ...)`` (`params_of`), and one
PermGraph container each (`hinm_plan`).  n_layers need not divide the
pattern: 38 layers are 12 full periods and a partial one (layers 36 and
37, the stacks' last entries), and every pass runs the layers in layer
order.

Serving.  The cache is a tuple with one dict a pattern position, every
leaf ``(n_j, B, ...)`` (slot axis 1) or, for a paged attention stack,
pool leaves ``(n_j, n_pages, page, ...)``:

  * an RG-LRU stack keeps its O(1) state slot-striped: ``h`` (float32)
    and ``conv``, the last CONV_K - 1 conv inputs (in the cache dtype);
    its pristine state is all zeros;
  * an attention stack keeps a ring of ``min(window, max_seq)`` rows a
    slot: a stripe, or pages of the shared pool (`page_geometry`: the
    view is the ring, and a slot's pages are reused in place once its
    positions wrap).  Every attention stack shares one block-table
    geometry, so physical page ids are pool-global.

Prompts are prefilled at their exact length (no bucketing: padded rows
would enter the recurrent state), from a template whose whole state
`rewind_cache` restores to pristine.  Decode positions come from the
first attention stack's ``pos``.

Speculative verify is sequential (`SPEC_VERIFY`): `verify_step` runs S
exact single-token decode steps, snapshotting before each the attention
row the step overwrites and the recurrent state; `cache_rollback`
restores the rejected steps' rows (in reverse step order) and selects
the recurrent state after the accepted ones.  A parallel multi-token
write would clobber live rows once the ring wraps mid-verify, and the
recurrent state integrates every token it sees.  A verify row is then
decode's by construction: the same calls.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import tree as T
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import paging, rglru, transformer
from repro_torch.models.module import PruneSpec

# recurrent blocks integrate padded rows into their state: admission
# groups prompts by exact length
BUCKETED_PREFILL = False
# attention stacks page their windowed ring into the shared pool; K2
# folds the sliding window into its kpos mask
PAGED_ATTN_KERNEL = True
# S exact decode steps with undo snapshots (see the module docstring)
SPEC_VERIFY = "sequential"


def pattern(cfg) -> tuple[str, ...]:
    return cfg.block_pattern or ("rec", "rec", "attn")


def counts(cfg) -> list[int]:
    """Layers at each pattern position (13 / 13 / 12 for 38 layers)."""
    plen = len(pattern(cfg))
    return [len(range(j, cfg.n_layers, plen)) for j in range(plen)]


def _attn_j(cfg) -> int:
    return pattern(cfg).index("attn")


class Layer(nn.Module):
    """A mixer (``kind_rec``: an `rglru.RGLRUBlock`; ``kind_attn``: a module
    with ``ln`` and ``attn``) and the MLP."""

    def __init__(self, kind: str, mixer: nn.Module, ln_mlp: M.Norm, mlp: L.MLP):
        super().__init__()
        self.kind = kind
        setattr(self, f"kind_{kind}", mixer)
        self.ln_mlp, self.mlp = ln_mlp, mlp


class AttnMixer(nn.Module):
    def __init__(self, ln: M.Norm, attn: L.Attention):
        super().__init__()
        self.ln, self.attn = ln, attn


class Hybrid(nn.Module):
    def __init__(self, embed: M.Embed, stacks: list[list[Layer]], ln_f: M.Norm,
                 lm_head: M.Linear):
        super().__init__()
        self.embed = embed
        self.n_stacks = len(stacks)
        for j, layers in enumerate(stacks):
            setattr(self, f"stack{j}", nn.ModuleList(layers))
        self.ln_f, self.lm_head = ln_f, lm_head

    @property
    def stacks(self) -> list[nn.ModuleList]:
        return [getattr(self, f"stack{j}") for j in range(self.n_stacks)]


def init_layer(cfg, kind: str, *, generator, device) -> Layer:
    kw = dict(generator=generator, device=device)
    if kind == "attn":
        mixer = AttnMixer(L.norm_init(cfg, device=device), L.attention_init(cfg, **kw))
    else:
        mixer = rglru.rglru_block_init(cfg, **kw)
    return Layer(kind, mixer, L.norm_init(cfg, device=device), L.mlp_init(cfg, **kw))


def init(cfg, generator: torch.Generator | None = None, device="cuda") -> Hybrid:
    """Random weights from `generator` (seeded by the caller), drawn layer
    by layer in model order."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device)
    kinds = pattern(cfg)
    stacks = [[] for _ in kinds]
    for i in range(cfg.n_layers):
        j = i % len(kinds)
        stacks[j].append(init_layer(cfg, kinds[j], **kw))
    return Hybrid(M.embed_init(cfg.vocab_padded, cfg.d_model, cfg.dtype, **kw), stacks,
                  L.norm_init(cfg, device=device),
                  M.dense_init(cfg.d_model, cfg.vocab_padded, cfg.dtype, **kw))


def params_of(model: Hybrid) -> dict:
    """The dense model's tensors as the reference's params tree: ``embed``,
    ``stacks`` (one tree a pattern position, leaves stacked over its
    layers, ``(n_j, ...)``), ``ln_f``, ``lm_head``; new tensors."""
    tree = {name: T.map(torch.clone, transformer._tree_of(getattr(model, name)))
            for name in ("embed", "ln_f", "lm_head")}
    tree["stacks"] = []
    for stack in model.stacks:
        per = [transformer._tree_of(layer) for layer in stack]
        tree["stacks"].append(T.map(lambda *xs: torch.stack(xs), per[0], *per[1:]))
    return tree


def layer_from(kind: str, node: dict, i: int, lin=M.linear_of, norm=M.norm_of,
               leaf=None) -> Layer:
    """Layer `i` of pattern position `kind` from a stacked tree `node` (the
    reference's ``stacks[j]``); `lin`, `norm` and `leaf` build its parts."""
    leaf = leaf or (lambda a, i: a[i])
    if kind == "attn":
        m = node["kind_attn"]
        mixer = AttnMixer(norm(m["ln"], i), L.Attention(
            *(lin(m["attn"][n], i) for n in ("wq", "wk", "wv", "wo"))))
    else:
        m = node["kind_rec"]
        mixer = rglru.RGLRUBlock(norm(m["ln"], i), lin(m["win"], i), lin(m["wgate"], i),
                                 leaf(m["conv"], i), lin(m["wa"], i), lin(m["wx"], i),
                                 leaf(m["lam"], i), lin(m["wout"], i))
    return Layer(kind, mixer, norm(node["ln_mlp"], i),
                 L.MLP(**{n: lin(sub, i) for n, sub in node["mlp"].items()}))


def from_params(cfg, params: dict) -> Hybrid:
    """A model whose tensors are `params`' own (layer-i views of the
    stacked leaves, no copies)."""
    stacks = []
    for kind, n, node in zip(pattern(cfg), counts(cfg), params["stacks"]):
        views = T.map(lambda t: t.unbind(0), node)
        stacks.append([layer_from(kind, views, i) for i in range(n)])
    return Hybrid(M.Embed(params["embed"]["table"]), stacks, M.norm_of(params["ln_f"]),
                  M.linear_of(params["lm_head"]))


def apply_layer(layer: Layer, cfg, x, positions, cache=None, backend: str = "auto"):
    """The mixer, then the MLP; `cache` (this layer's views) in place."""
    if layer.kind == "attn":
        m = layer.kind_attn
        x = x + L.attention(m.attn, L.norm(m.ln, x, cfg), positions, cfg, cache,
                            backend=backend)
    else:
        x = rglru.rglru_block(layer.kind_rec, cfg, x, cache, backend)
    return x + L.mlp(layer.mlp, L.norm(layer.ln_mlp, x, cfg), cfg, backend)


def _layer_cache(cache: dict, i: int) -> dict:
    return {k: v[i] for k, v in cache.items()}


def _run(model: Hybrid, cfg, x, positions, caches=None, backend: str = "auto"):
    """Every layer in layer order (the full periods, then the partial
    one); layer i takes its views of `caches[i % plen]` (written in
    place)."""
    plen, stacks = len(pattern(cfg)), model.stacks
    for i in range(cfg.n_layers):
        j, n = i % plen, i // plen
        x = apply_layer(stacks[j][n], cfg, x, positions,
                        None if caches is None else _layer_cache(caches[j], n), backend)
    return x


def _positions(s: int, b: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(model: Hybrid, cfg, tokens, embeds=None, backend: str = "auto",
            remat: bool = False):
    """Training / eval forward: pre-logits (B, S, D).  `remat` checkpoints
    each layer."""
    x = M.embed(model.embed, tokens)
    b, s, _ = x.shape
    positions = _positions(s, b, x.device)
    if remat:
        from torch.utils.checkpoint import checkpoint

        plen = len(pattern(cfg))
        for i in range(cfg.n_layers):
            x = checkpoint(apply_layer, model.stacks[i % plen][i // plen], cfg, x, positions,
                           None, backend, use_reentrant=False)
    else:
        x = _run(model, cfg, x, positions, backend=backend)
    return L.norm(model.ln_f, x, cfg)


def logits_fn(model: Hybrid, x: torch.Tensor) -> torch.Tensor:
    return M.linear(model.lm_head, x)


def _view(cfg, max_seq: int) -> int:
    return min(cfg.window or max_seq, max_seq)


def make_cache(cfg, batch: int, max_seq: int, dtype=None, page=None, n_pages=None,
               device="cuda") -> tuple:
    """The pristine cache: one dict a pattern position (see the module
    docstring); with ``page``/``n_pages`` the attention stacks are paged."""
    dtype = dtype or cfg.dtype
    win, r = _view(cfg, max_seq), rglru.width(cfg)
    geom = page_geometry(cfg, max_seq, page) if page is not None else None
    caches = []
    for kind, n in zip(pattern(cfg), counts(cfg)):
        if kind != "attn":
            caches.append({
                "h": torch.zeros((n, batch, r), dtype=torch.float32, device=device),
                "conv": torch.zeros((n, batch, rglru.CONV_K - 1, r), dtype=dtype,
                                    device=device)})
        elif geom is not None:
            c = paging.make_attn_pool(n, n_pages, geom["page"], cfg.n_kv_heads, cfg.head_dim,
                                      dtype, device)
            c["pos"] = torch.zeros((n, batch), dtype=torch.int32, device=device)
            c.update(paging.make_tables(n, batch, geom["n_bt"], device))
            caches.append(c)
        else:
            shape = (n, batch, win, cfg.n_kv_heads, cfg.head_dim)
            caches.append({
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.zeros((n, batch), dtype=torch.int32, device=device),
                "kpos": torch.full((n, batch, win), paging.KPOS_SENTINEL, dtype=torch.int32,
                                   device=device)})
    return tuple(caches)


def reset_cache(cfg, cache) -> None:
    """Every leaf back to its pristine value, in place: attention stacks
    their sentinels, recurrent state zeros."""
    for c in cache:
        if "k" in c:
            paging.reset_attn(c)
        else:
            for leaf in c.values():
                leaf.zero_()


def rewind_cache(cfg, cache) -> None:
    """A reused prefill template back to pristine, in place: a prefill
    starts from the recurrent state it is given and writes its attention
    rows from position 0."""
    reset_cache(cfg, cache)


def cache_batch_axes(cfg, cache):
    """Slot axis per cache leaf: 1, or None for a paged pool's page
    buffers."""
    def one(c):
        pooled = ("k", "v", "kpos") if paging.is_paged(c) else ()
        return {name: None if name in pooled else 1 for name in c}

    return tuple(one(c) for c in cache)


def cache_shard_roles(cfg, cache) -> tuple:
    """Sharding role per cache leaf: paged attention stacks shard their
    page axis, stripe ones their slot axis, and the RG-LRU stacks are
    per-slot state (batch over dp, the feature dim over 'model')."""
    def one(c):
        if paging.is_paged(c):
            return paging.paged_roles(c)
        if "k" in c:
            return {"k": "kv", "v": "kv", "pos": "slot", "kpos": "slot"}
        return {k: "state" for k in c}

    return tuple(one(c) for c in cache)


def page_geometry(cfg, max_seq: int, page: int) -> dict:
    """The live view of an attention stack is the ring, not max_seq: pages
    cover ``min(window, max_seq)`` rows and are reused in place once
    positions wrap."""
    return paging.geometry(_view(cfg, max_seq), page)


def paged_insert(cfg, pool, stripe, slot, row, scatter_ids, bt_row, n_alloc):
    """Row `row` of a prefilled stripe cache into slot `slot`, in place:
    attention stacks scatter into their pages, recurrent state is copied."""
    for pc, sc in zip(pool, stripe):
        if paging.is_paged(pc):
            paging.insert_attn(pc, sc, row, scatter_ids, bt_row, n_alloc, slot)
        else:
            for name in pc:
                paging.copy_slot_row(pc[name], sc[name], slot, row, 1)
    return pool


def paged_release(cfg, pool, slot, page_ids):
    """Release `slot`, in place: its freed pages swept, its recurrent state
    back to zeros."""
    for pc in pool:
        if paging.is_paged(pc):
            paging.release_attn(pc, page_ids, slot)
        else:
            for leaf in pc.values():
                paging.reset_slot_row(leaf, slot, 1)
    return pool


def prefill(model: Hybrid, cfg, tokens, cache, embeds=None, n_rows=None,
            backend: str = "auto"):
    """Run the prompts `tokens (B, S)` (every row a real token) from
    `cache`'s state, leaving their rows and the state after them there in
    place; returns last-token pre-logits (B, D)."""
    if n_rows is not None:
        raise ValueError("hybrid prefill cannot be length-bucketed: recurrent"
                         " blocks would integrate the padded rows")
    x = M.embed(model.embed, tokens)
    b, s, _ = x.shape
    x = _run(model, cfg, x, _positions(s, b, x.device), cache, backend)
    return L.norm(model.ln_f, x[:, -1], cfg)


def decode_step(model: Hybrid, cfg, tokens, cache, backend: str = "auto"):
    """One decode step. tokens (B, 1); returns logits (B, vocab_padded) and
    advances the cache in place.  Each slot's position is the first
    attention stack's ``pos`` (a copy: the layers advance theirs)."""
    x = M.embed(model.embed, tokens)
    positions = cache[_attn_j(cfg)]["pos"][0].clone()[:, None]
    x = _run(model, cfg, x, positions, cache, backend)
    return logits_fn(model, L.norm(model.ln_f, x[:, 0], cfg))


def cache_position(cfg, cache) -> torch.Tensor:
    """Per-slot cache write position (B,) int32, a copy."""
    return cache[_attn_j(cfg)]["pos"][0].clone()


def _spec_snapshot(cfg, cache) -> tuple:
    """Per stack, before a step: the attention row the step will
    overwrite, or a copy of the recurrent state."""
    win = bool(cfg.window)
    return tuple(paging.snapshot_attn_row(c, window=win) if "k" in c
                 else {name: leaf.clone() for name, leaf in c.items()} for c in cache)


def verify_step(model: Hybrid, cfg, tokens, cache, backend: str = "auto"):
    """Sequential speculative verify: ``tokens (B, S)`` through S exact
    single-token decode steps, in place.  Returns (logits (B, S,
    vocab_padded), undo): undo is `_spec_snapshot`'s tree with every leaf
    stacked over the steps, ``(S, ...)``."""
    logits, snaps = [], []
    for i in range(tokens.shape[1]):
        snaps.append(_spec_snapshot(cfg, cache))
        logits.append(decode_step(model, cfg, tokens[:, i:i + 1], cache, backend))
    return torch.stack(logits, dim=1), T.map(lambda *xs: torch.stack(xs), snaps[0], *snaps[1:])


def cache_rollback(cfg, cache, undo, pos0, keep, n_written):
    """Keep ``keep (B,)`` of the ``n_written`` verify steps per slot, in
    place: the rejected steps' attention rows return to their snapshots
    (reverse step order) with ``pos`` rewound to ``pos0 + keep``, and the
    recurrent state becomes the one after ``keep`` steps."""
    if undo is None:
        raise ValueError("a sequential verify's rollback needs its undo snapshots")
    win = bool(cfg.window)
    for c, u in zip(cache, undo):
        if "k" in c:
            paging.restore_attn_rows(c, u, pos0, keep, n_written, window=win)
        else:
            for name, leaf in c.items():
                leaf.copy_(paging.select_state(u[name], leaf, keep))
    return cache


def hinm_plan(cfg) -> dict[int, list[PruneSpec]]:
    """One plan a pattern position (its own PermGraph container): the
    attention projections as the transformer's (``wv`` in KV row blocks,
    its permutation folded into ``wo``), the RG-LRU's five ICP only, and
    the MLP."""
    plans = {}
    for j, kind in enumerate(pattern(cfg)):
        if kind == "attn":
            specs = [PruneSpec("kind_attn/attn/wq", can_permute_rows=False),
                     PruneSpec("kind_attn/attn/wk", can_permute_rows=False),
                     PruneSpec("kind_attn/attn/wv", row_blocks=cfg.n_kv_heads,
                               consumers=("kind_attn/attn/wo:gqa",)),
                     PruneSpec("kind_attn/attn/wo", can_permute_rows=False)]
        else:
            specs = rglru.rglru_plan_specs("kind_rec/")
        if cfg.act == "swiglu":
            specs += [PruneSpec("mlp/wg", tied=("mlp/wu",), consumers=("mlp/wd",)),
                      PruneSpec("mlp/wd", can_permute_rows=False)]
        else:
            specs += [PruneSpec("mlp/wu", consumers=("mlp/wd",)),
                      PruneSpec("mlp/wd", can_permute_rows=False)]
        plans[j] = specs
    return plans
