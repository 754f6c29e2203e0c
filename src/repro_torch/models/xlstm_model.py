"""xLSTM model (port of `repro.models.xlstm_model`, xlstm-125m):
alternating (mLSTM, sLSTM) blocks, no separate FFN (the blocks carry their
own projections; cfg.d_model alone sizes them).

Layer i sits in period i // len(pattern) at pattern position
i % len(pattern).  The model keeps one `nn.ModuleList` a pattern
position, ``stack0`` (the mLSTMs), ``stack1`` (the sLSTMs), each over the
periods: the reference's ``stacks[j]`` with leaves stacked ``(n_p, ...)``
(`params_of`), and one PermGraph container each (`hinm_plan`).

Serving: the state is O(1) in sequence length, so there is no KV, no page
pool (a requested page falls back to stripes: no `page_geometry`) and no
bucketed prefill (padded rows would enter the state).  The cache is a
tuple with one dict a pattern position, every leaf ``(n_p, B, ...)``
float32, slot axis 1.  Its pristine state is not all zeros (mLSTM's
stabiliser ``m`` starts at -1e30, sLSTM's normaliser ``n`` at 1):
`reset_cache` restores it in place, and `rewind_cache` is that reset,
since a prefill reads its template's state as its initial state.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import transformer
from repro_torch.models import xlstm as X

# fully recurrent: no paged KV and no bucketed prefill, hence nothing for
# the paged-attention kernel to resolve
BUCKETED_PREFILL = False
PAGED_ATTN_KERNEL = False

_BLOCKS = {"mlstm": (X.mlstm_init, X.mlstm_block), "slstm": (X.slstm_init, X.slstm_block)}
# each block kind's pristine state, by leaf (0 where not named)
_PRISTINE = {"mlstm": {"m": -1e30}, "slstm": {"n": 1.0}}


def pattern(cfg) -> tuple[str, ...]:
    return cfg.block_pattern or ("mlstm", "slstm")


def n_periods(cfg) -> int:
    return cfg.n_layers // len(pattern(cfg))


class XLSTM(nn.Module):
    def __init__(self, embed: M.Embed, stacks: list[list[nn.Module]], ln_f: M.Norm,
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


def init(cfg, generator: torch.Generator | None = None, device="cuda") -> XLSTM:
    """Random weights from `generator` (seeded by the caller), drawn layer
    by layer in model order."""
    device = resolve_device(device)
    if cfg.n_layers % len(pattern(cfg)):
        raise ValueError("xlstm n_layers must divide the block pattern")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device)
    stacks = [[] for _ in pattern(cfg)]
    for _ in range(n_periods(cfg)):
        for j, kind in enumerate(pattern(cfg)):
            stacks[j].append(_BLOCKS[kind][0](cfg, **kw))
    return XLSTM(M.embed_init(cfg.vocab_padded, cfg.d_model, cfg.dtype, **kw), stacks,
                 L.norm_init(cfg, device=device),
                 M.dense_init(cfg.d_model, cfg.vocab_padded, cfg.dtype, **kw))


def params_of(model: XLSTM) -> dict:
    """The dense model's tensors as the reference's params tree: ``embed``,
    ``stacks`` (one tree a pattern position, leaves stacked over its
    periods, ``(n_p, ...)``), ``ln_f``, ``lm_head``; new tensors."""
    tree = {name: T.map(torch.clone, transformer._tree_of(getattr(model, name)))
            for name in ("embed", "ln_f", "lm_head")}
    tree["stacks"] = []
    for stack in model.stacks:
        per = [transformer._tree_of(blk) for blk in stack]
        tree["stacks"].append(T.map(lambda *xs: torch.stack(xs), per[0], *per[1:]))
    return tree


def block_from(kind: str, node: dict, i: int, lin=M.linear_of, norm=M.norm_of,
               leaf=None) -> nn.Module:
    """Period `i`'s block of kind `kind` from a stacked tree `node` (the
    reference's ``stacks[j]``); `lin`, `norm` and `leaf` build its parts."""
    leaf = leaf or (lambda a, i: a[i])
    if kind == "mlstm":
        return X.MLSTMBlock(norm(node["ln"], i), *(lin(node[n], i) for n in (
            "wq", "wk", "wv", "wi", "wf", "wo_gate", "wout")))
    return X.SLSTMBlock(norm(node["ln"], i), *(lin(node[n], i) for n in ("wz", "wi", "wf", "wo")),
                        leaf(node["r"], i), lin(node["wout"], i))


def from_params(cfg, params: dict) -> XLSTM:
    """A model whose tensors are `params`' own (period-i views of the
    stacked leaves, no copies)."""
    stacks = []
    for kind, node in zip(pattern(cfg), params["stacks"]):
        views = T.map(lambda t: t.unbind(0), node)
        stacks.append([block_from(kind, views, i) for i in range(n_periods(cfg))])
    return XLSTM(M.Embed(params["embed"]["table"]), stacks, M.norm_of(params["ln_f"]),
                 M.linear_of(params["lm_head"]))


def _layer_cache(cache: dict, i: int) -> dict:
    return {k: v[i] for k, v in cache.items()}


def _run(model: XLSTM, cfg, x, caches=None, backend: str = "auto", remat: bool = False):
    """Every layer in model order; period p's blocks take their views of
    `caches` (written in place)."""
    stacks = model.stacks
    for p in range(n_periods(cfg)):
        for j, kind in enumerate(pattern(cfg)):
            fn, blk = _BLOCKS[kind][1], stacks[j][p]
            if remat:
                x = checkpoint(fn, blk, cfg, x, None, backend, use_reentrant=False)
            else:
                x = fn(blk, cfg, x, None if caches is None else _layer_cache(caches[j], p),
                       backend)
    return x


def forward(model: XLSTM, cfg, tokens, embeds=None, backend: str = "auto",
            remat: bool = False):
    """Training / eval forward: pre-logits (B, S, D).  `remat` checkpoints
    each block."""
    x = _run(model, cfg, M.embed(model.embed, tokens), backend=backend, remat=remat)
    return L.norm(model.ln_f, x, cfg)


def logits_fn(model: XLSTM, x: torch.Tensor) -> torch.Tensor:
    return M.linear(model.lm_head, x)


def _state_shapes(cfg, kind: str, batch: int) -> dict:
    n_p, d, h = n_periods(cfg), cfg.d_model, cfg.n_heads
    dk = X.head_dim(cfg)
    if kind == "mlstm":
        return {"c": (n_p, batch, h, dk, dk), "n": (n_p, batch, h, dk), "m": (n_p, batch, h)}
    return {name: (n_p, batch, d) for name in ("c", "n", "h", "m")}


def make_cache(cfg, batch: int, max_seq: int, dtype=None, page=None, n_pages=None,
               device="cuda") -> tuple:
    """The pristine recurrent state: one dict a pattern position, leaves
    ``(n_p, B, ...)`` float32.  O(1) in sequence length, so `max_seq`,
    `page` and `n_pages` size nothing (the pool never asks for pages: the
    family has no `page_geometry`); `dtype` is the model's, not the
    state's."""
    del max_seq, dtype, page, n_pages
    cache = tuple({name: torch.empty(shape, dtype=torch.float32, device=device)
                   for name, shape in _state_shapes(cfg, kind, batch).items()}
                  for kind in pattern(cfg))
    reset_cache(cfg, cache)
    return cache


def reset_cache(cfg, cache) -> None:
    """Every leaf back to its pristine value, in place."""
    for kind, leaves in zip(pattern(cfg), cache):
        for name, leaf in leaves.items():
            leaf.fill_(_PRISTINE[kind].get(name, 0.0))


def cache_batch_axes(cfg, cache):
    """Slot (batch) axis per cache leaf: 1 everywhere ((n_p, B, ...))."""
    return T.map(lambda _: 1, cache)


def cache_shard_roles(cfg, cache):
    """Every leaf is O(1)-per-slot recurrent state (n_p, B, feat...): batch
    over dp, the feature dim over 'model'.  There is no paged layout (the
    pool falls back to stripes)."""
    return T.map(lambda _: "state", cache)


def rewind_cache(cfg, cache) -> None:
    """A reused prefill template's state back to pristine, in place: a
    recurrent prefill starts from the state it is given, so the last
    group's would enter the next group's prompts."""
    reset_cache(cfg, cache)


def prefill(model: XLSTM, cfg, tokens, cache, embeds=None, n_rows=None,
            backend: str = "auto"):
    """Run the prompts `tokens (B, S)` (every row a real token: prompts are
    grouped by exact length) from `cache`'s state, leaving the state after
    them there in place; returns last-token pre-logits (B, D)."""
    if n_rows is not None:
        raise ValueError("xlstm prefill cannot be length-bucketed: recurrent"
                         " state would integrate the padded rows")
    x = _run(model, cfg, M.embed(model.embed, tokens), cache, backend)
    return L.norm(model.ln_f, x[:, -1], cfg)


def decode_step(model: XLSTM, cfg, tokens, cache, backend: str = "auto"):
    """One decode step. tokens (B, 1); returns logits (B, vocab_padded) and
    advances the state in place."""
    x = _run(model, cfg, M.embed(model.embed, tokens), cache, backend)
    return logits_fn(model, L.norm(model.ln_f, x[:, 0], cfg))


def hinm_plan(cfg) -> dict[int, list]:
    """One plan a pattern position (its own PermGraph container)."""
    return {j: X.xlstm_plan_specs(kind) for j, kind in enumerate(pattern(cfg))}
