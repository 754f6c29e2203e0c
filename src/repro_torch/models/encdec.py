"""Encoder-decoder transformer (port of `repro.models.encdec`, the
seamless-m4t backbone).

The speech frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings (B, T_enc, D), which `frontend_proj` maps into
the encoder.  Encoder layers: bidirectional self-attention (RoPE) + FFN.
Decoder layers: causal self-attention (RoPE) + cross-attention to the
encoder output (no positional rotation) + FFN.

Serving: the decoder's self-attention pages into the shared pool through
K2, as the dense family's does; each slot also keeps its encoder output at
the pool's fixed width ``t_enc`` (``enc_out``, with ``enc_len`` valid
rows), written once at admission and read by every decode step's
cross-attention.  As in the reference, the cross-attention's k/v are
projected from ``enc_out`` again at every step, through K1 over slots x
``t_enc`` rows.  Every projection of both stacks runs through K1 once
packed.  The cache's ``self`` leaves are the transformer's and are written
in place; ``enc_out`` and ``enc_len`` are per-slot leaves (slot axis 0).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import moe as MOE
from repro_torch.models import paging, transformer
from repro_torch.models.module import PruneSpec

# the decoder is pure attention (self + cross), so decoder-prompt rows can
# be bucketed with sentinel-position masking; encoder frames stay exact
BUCKETED_PREFILL = True
# decoder self-attention pages into the shared pool (cross-attention reads
# the per-slot enc_out), so the paged-attention kernel applies
PAGED_ATTN_KERNEL = True
# serve/spec: the decoder is pure attention (self + cross), so one parallel
# forward verifies all candidate rows; cross-attention reads only the
# per-slot cached encoder output, which speculation never mutates
SPEC_VERIFY = "parallel"


class EncLayer(nn.Module):
    def __init__(self, ln1: M.Norm, attn: L.Attention, ln2: M.Norm, mlp: L.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp

    def forward(self, x, positions, cfg, backend: str = "auto"):
        x = x + L.attention(self.attn, L.norm(self.ln1, x, cfg), positions, cfg,
                            backend=backend, bidirectional=True)
        return x + L.mlp(self.mlp, L.norm(self.ln2, x, cfg), cfg, backend)


class DecLayer(nn.Module):
    def __init__(self, ln1: M.Norm, attn: L.Attention, ln_x: M.Norm, xattn: L.Attention,
                 ln2: M.Norm, mlp: L.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln_x, self.xattn = ln1, attn, ln_x, xattn
        self.ln2, self.mlp = ln2, mlp

    def forward(self, x, positions, enc_out, cfg, cache=None, enc_len=None,
                backend: str = "auto", spec: bool = False, variant: str | None = None):
        x = x + L.attention(self.attn, L.norm(self.ln1, x, cfg), positions, cfg, cache,
                            backend=backend, spec=spec, variant=variant)
        x = x + _cross_attention(self.xattn, L.norm(self.ln_x, x, cfg), enc_out, cfg,
                                 enc_len, backend, variant)
        return x + L.mlp(self.mlp, L.norm(self.ln2, x, cfg), cfg, backend, variant)


class EncDec(nn.Module):
    def __init__(self, frontend_proj: M.Linear, embed: M.Embed, enc: list[EncLayer],
                 dec: list[DecLayer], ln_enc: M.Norm, ln_f: M.Norm, lm_head: M.Linear):
        super().__init__()
        self.frontend_proj, self.embed = frontend_proj, embed
        self.enc, self.dec = nn.ModuleList(enc), nn.ModuleList(dec)
        self.ln_enc, self.ln_f, self.lm_head = ln_enc, ln_f, lm_head


def n_enc_layers(cfg) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def init(cfg, generator: torch.Generator | None = None, device="cuda") -> EncDec:
    """Random weights from `generator` (seeded by the caller)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device)

    def norm():
        return L.norm_init(cfg, device=device)

    enc = [EncLayer(norm(), L.attention_init(cfg, **kw), norm(), L.mlp_init(cfg, **kw))
           for _ in range(n_enc_layers(cfg))]
    dec = [DecLayer(norm(), L.attention_init(cfg, **kw), norm(), L.attention_init(cfg, **kw),
                    norm(), L.mlp_init(cfg, **kw))
           for _ in range(cfg.n_layers)]
    return EncDec(M.dense_init(cfg.d_model, cfg.d_model, cfg.dtype, **kw),
                  M.embed_init(cfg.vocab_padded, cfg.d_model, cfg.dtype, **kw),
                  enc, dec, norm(), norm(),
                  M.dense_init(cfg.d_model, cfg.vocab_padded, cfg.dtype, **kw))


def params_of(model: EncDec) -> dict:
    """The dense model's tensors as the reference's params tree: ``enc`` and
    ``dec`` leaves stacked over their layers, ``(L, ...)``; new tensors."""
    tree = {name: T.map(torch.clone, transformer._tree_of(child))
            for name, child in model.named_children() if name not in ("enc", "dec")}
    for name in ("enc", "dec"):
        per = [transformer._tree_of(layer) for layer in getattr(model, name)]
        tree[name] = T.map(lambda *xs: torch.stack(xs), per[0], *per[1:])
    return tree


def _attn(node, i) -> L.Attention:
    return L.Attention(*(M.linear_of(node[n], i) for n in ("wq", "wk", "wv", "wo")))


def _mlp(node, i) -> L.MLP:
    return L.MLP(**{n: M.linear_of(sub, i) for n, sub in node.items()})


def from_params(cfg, params: dict) -> EncDec:
    """A model whose tensors are `params`' own (layer-i views of the
    stacked leaves, no copies)."""
    enc = T.map(lambda t: t.unbind(0), params["enc"])
    dec = T.map(lambda t: t.unbind(0), params["dec"])
    return EncDec(
        M.linear_of(params["frontend_proj"]), M.Embed(params["embed"]["table"]),
        [EncLayer(M.norm_of(enc["ln1"], i), _attn(enc["attn"], i), M.norm_of(enc["ln2"], i),
                  _mlp(enc["mlp"], i)) for i in range(n_enc_layers(cfg))],
        [DecLayer(M.norm_of(dec["ln1"], i), _attn(dec["attn"], i), M.norm_of(dec["ln_x"], i),
                  _attn(dec["xattn"], i), M.norm_of(dec["ln2"], i), _mlp(dec["mlp"], i))
         for i in range(cfg.n_layers)],
        M.norm_of(params["ln_enc"]), M.norm_of(params["ln_f"]), M.linear_of(params["lm_head"]))


def _cross_attention(p: L.Attention, x, enc_out, cfg, enc_len=None, backend: str = "auto",
                     variant: str | None = None) -> torch.Tensor:
    """Queries from x, keys/values from enc_out, no rotation.

    `enc_len` (B,) masks padded encoder rows when `enc_out` comes from the
    pool's fixed width (the reference's causal mask with valid rows at key
    position 0 and queries at 0: an attend over the valid rows), and then
    the attend sums in a fixed order (`_attend_fixed`); without it (the
    eval forward) it is `_attn_chunked` over every row.  The k/v
    projections run over B x T rows whatever the query rows are, so
    they take the K1 variant the dispatch picks for those rows, not
    `variant` (a verify's k/v are then decode's, bit for bit)."""
    b, s, _ = x.shape
    t = enc_out.shape[1]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = M.linear(p.wq, x, backend, variant).reshape(b, s, h, hd)
    k = M.linear(p.wk, enc_out, backend).reshape(b, t, kvh, hd)
    v = M.linear(p.wv, enc_out, backend).reshape(b, t, kvh, hd)
    if enc_len is None:
        qp = torch.zeros((b, s), dtype=torch.int32, device=x.device)
        kp = torch.zeros((b, t), dtype=torch.int32, device=x.device)
        out = L._attn_chunked(q, k, v, qp, kp, False, 0)
    else:
        valid = torch.arange(t, device=x.device)[None, :] < enc_len[:, None]
        out = _attend_fixed(q, k, v, valid)
    return M.linear(p.wo, out.reshape(b, s, h * hd), backend, variant)


def _attend_fixed(q, k, v, valid) -> torch.Tensor:
    """Softmax attention of q (B, S, H, hd) over the `valid` (B, T) rows of
    k / v (B, T, KV, hd), every sum (the scores' dot products, the
    softmax's denominator, the weighted values) in `moe._fixed_sum`'s
    order: a query row's bits depend on its own inputs only, not on how
    many rows the call holds.  The serving path's cross-attention: a
    verify's s rows are then bitwise its s decode steps', where cuBLAS's
    matmuls of `layers._attn_chunked` pick their reduction by the query
    count.  Masked rows weigh exp(NEG_INF - m) = 0, as there."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = (q.float() * hd ** -0.5).reshape(b, s, kvh, g, 1, hd)
    kf = k.float().permute(0, 2, 1, 3).reshape(b, 1, kvh, 1, t, hd)
    vf = v.float().permute(0, 2, 1, 3).reshape(b, 1, kvh, 1, t, hd)
    sc = MOE._fixed_sum(qf * kf)                            # (B, S, KV, G, T)
    sc = torch.where(valid[:, None, None, None, :], sc, L.NEG_INF)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    out = MOE._fixed_sum(p[..., None] * vf, dim=-2) / torch.clamp(
        MOE._fixed_sum(p)[..., None], min=1e-30)
    return out.reshape(b, s, h, hd).to(q.dtype)


def encode(model: EncDec, cfg, frames: torch.Tensor, backend: str = "auto",
           remat: bool = False) -> torch.Tensor:
    """frames: (B, T, D) stub embeddings -> encoder output (B, T, D)."""
    x = M.linear(model.frontend_proj, frames.to(cfg.dtype), backend)
    b, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    for layer in model.enc:
        x = (checkpoint(layer, x, positions, cfg, backend, use_reentrant=False) if remat
             else layer(x, positions, cfg, backend))
    return L.norm(model.ln_enc, x, cfg)


def _dec_stack(model, cfg, x, positions, enc_out, cache=None, enc_len=None,
               backend: str = "auto", spec: bool = False, variant=None, remat: bool = False):
    for i, layer in enumerate(model.dec):
        if remat:
            x = checkpoint(layer, x, positions, enc_out, cfg, None, None, backend,
                           use_reentrant=False)
        else:
            x = layer(x, positions, enc_out, cfg,
                      None if cache is None else transformer._layer_cache(cache, i),
                      enc_len, backend, spec, variant)
    return x


def forward(model: EncDec, cfg, tokens, embeds=None, backend: str = "auto",
            remat: bool = False):
    """Training / eval: embeds = the frame stub (B, T_enc, D); tokens = the
    decoder input.  Returns pre-logits (B, S, D)."""
    if embeds is None:
        raise ValueError("enc-dec forward requires frontend frame embeddings")
    enc_out = encode(model, cfg, embeds, backend, remat)
    x = M.embed(model.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x = _dec_stack(model, cfg, x, positions, enc_out, backend=backend, remat=remat)
    return L.norm(model.ln_f, x, cfg)


def logits_fn(model: EncDec, x: torch.Tensor) -> torch.Tensor:
    return M.linear(model.lm_head, x)


def make_cache(cfg, batch: int, max_seq: int, dtype=None, t_enc: int | None = None,
               page=None, n_pages=None, device="cuda") -> dict:
    """The decoder's self-attention cache (the transformer's: stripes, or
    with ``page``/``n_pages`` the shared page pool) under ``self``, and
    each slot's encoder output at the fixed width ``t_enc`` (default
    max_seq) with its count of valid rows."""
    dtype = dtype or cfg.dtype
    return {
        "self": transformer.make_cache(cfg, batch, max_seq, dtype, page, n_pages, device),
        "enc_out": torch.zeros((batch, t_enc or max_seq, cfg.d_model), dtype=dtype,
                               device=device),
        "enc_len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_batch_axes(cfg, cache) -> dict:
    """The slot axis of each stripe-cache leaf: the decoder's (L, B, ...)
    leaves 1, the cached encoder output and its length 0."""
    return {"self": transformer.cache_batch_axes(cfg, cache["self"]),
            "enc_out": 0, "enc_len": 0}


def reset_cache(cfg, cache) -> None:
    paging.reset_attn(cache["self"])
    cache["enc_out"].zero_()
    cache["enc_len"].zero_()


def cache_shard_roles(cfg, cache) -> dict:
    """Sharding role per cache leaf: the decoder's self-attention cache as
    the decoder-only stack's; the cached encoder output and length are
    per-slot encoder leaves (batch at axis 0)."""
    if paging.is_paged(cache["self"]):
        self_roles = paging.paged_roles(cache["self"])
    else:
        self_roles = {"k": "kv", "v": "kv", "pos": "slot", "kpos": "slot"}
    return {"self": self_roles, "enc_out": "enc", "enc_len": "enc"}


def page_geometry(cfg, max_seq: int, page: int) -> dict:
    """Only the decoder's self-attention K/V is paged; the encoder output is
    a per-slot stripe (written at admission, read-only after)."""
    return paging.geometry(max_seq, page)


def paged_insert(cfg, pool, stripe, slot, row, scatter_ids, bt_row, n_alloc):
    """Insert row `row` of a prefilled stripe cache into paged-pool slot
    `slot`, in place: the decoder's rows into their pages, the encoder
    output and its length into the slot's rows."""
    paging.insert_attn(pool["self"], stripe["self"], row, scatter_ids, bt_row, n_alloc, slot)
    paging.copy_slot_row(pool["enc_out"], stripe["enc_out"], slot, row, 0)
    paging.copy_slot_row(pool["enc_len"], stripe["enc_len"], slot, row, 0)
    return pool


def paged_release(cfg, pool, slot, page_ids):
    paging.release_attn(pool["self"], page_ids, slot)
    paging.reset_slot_row(pool["enc_out"], slot, 0)
    paging.reset_slot_row(pool["enc_len"], slot, 0)
    return pool


def _positions(x, n_rows):
    b, s, _ = x.shape
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    if n_rows is None:
        return ar.expand(b, s)
    # bucketed decoder prompt: padded rows carry the sentinel position, so
    # their cached kpos masks them out of every later attend
    return torch.where(ar[None, :] < n_rows[:, None], ar[None, :],
                       paging.KPOS_SENTINEL).to(torch.int32)


def prefill(model, cfg, tokens, cache, embeds=None, n_rows=None, backend: str = "auto"):
    """Encode `embeds` (B, T, D) frames, then fill the decoder's stripe
    cache in place; returns last-token pre-logits (B, D).  The encoder
    output lands in the cache's first T ``enc_out`` rows with ``enc_len``
    T (the prefill itself attends over exactly those T rows, as the
    reference's does).  Without `embeds` the cache's encoder output is
    used as it is.  `n_rows` (B,) buckets the decoder prompt as the
    transformer's prefill does."""
    b = tokens.shape[0]
    if embeds is not None:
        enc_out = encode(model, cfg, embeds, backend)
        t = enc_out.shape[1]
        if t > cache["enc_out"].shape[1]:
            raise ValueError(f"{t} encoder frames exceed the cache's t_enc "
                             f"{cache['enc_out'].shape[1]}")
        enc_len = torch.full((b,), t, dtype=torch.int32, device=enc_out.device)
    else:
        enc_out, enc_len = cache["enc_out"], cache["enc_len"]
    x = M.embed(model.embed, tokens)
    x = _dec_stack(model, cfg, x, _positions(x, n_rows), enc_out, cache["self"], enc_len,
                   backend)
    x = L.norm(model.ln_f, x, cfg)
    if embeds is not None:
        cache["enc_out"][:, :t] = enc_out.to(cache["enc_out"].dtype)
        cache["enc_len"].copy_(enc_len)
    if n_rows is None:
        return x[:, -1]
    cache["self"]["pos"][:] = n_rows.to(torch.int32)[None, :]
    return x[torch.arange(b, device=x.device), (n_rows - 1).long()]


def decode_step(model, cfg, tokens, cache, backend: str = "auto"):
    """One decode step. tokens (B, 1); returns logits (B, vocab_padded) and
    advances the cache in place."""
    x = M.embed(model.embed, tokens)
    positions = cache["self"]["pos"][0].clone()[:, None]
    x = _dec_stack(model, cfg, x, positions, cache["enc_out"], cache["self"],
                   cache["enc_len"], backend)
    x = L.norm(model.ln_f, x, cfg)
    return logits_fn(model, x[:, 0])


def cache_position(cfg, cache) -> torch.Tensor:
    return cache["self"]["pos"][0].clone()


def rewind_cache(cfg, cache) -> None:
    cache["self"]["pos"].zero_()


def verify_step(model, cfg, tokens, cache, backend: str = "auto"):
    """Speculative verify over the decoder (see `transformer.verify_step`):
    the decoder's projections take the K1 variant decode's B slots run, so
    that row i is meant to be bitwise decode step i; returns (logits
    (B, S, vocab_padded), undo None)."""
    b, s = tokens.shape
    x = M.embed(model.embed, tokens)
    positions = (cache["self"]["pos"][0][:, None]
                 + torch.arange(s, dtype=torch.int32, device=x.device)[None, :])
    x = _dec_stack(model, cfg, x, positions, cache["enc_out"], cache["self"],
                   cache["enc_len"], backend, spec=True,
                   variant=transformer._decode_variant(model.dec[0].attn.wo.w, b, x))
    x = L.norm(model.ln_f, x, cfg)
    return logits_fn(model, x), None


def cache_rollback(cfg, cache, undo, pos0, keep, n_written):
    """Keep ``keep (B,)`` of the ``n_written`` rows per slot in the
    decoder's self-attention cache, in place; the encoder output stays."""
    transformer.cache_rollback(cfg, cache["self"], undo, pos0, keep, n_written)
    return cache


def hinm_plan(cfg) -> dict[str, list[PruneSpec]]:
    """The encoder's and the decoder's per-layer plans (the decoder's adds
    the cross-attention's four projections)."""
    def attn_specs(prefix):
        return [
            PruneSpec(f"{prefix}/wq", can_permute_rows=False),
            PruneSpec(f"{prefix}/wk", can_permute_rows=False),
            PruneSpec(f"{prefix}/wv", row_blocks=cfg.n_kv_heads,
                      consumers=(f"{prefix}/wo:gqa",)),
            PruneSpec(f"{prefix}/wo", can_permute_rows=False),
        ]

    mlp_specs = ([PruneSpec("mlp/wg", tied=("mlp/wu",), consumers=("mlp/wd",)),
                  PruneSpec("mlp/wd", can_permute_rows=False)] if cfg.act == "swiglu" else
                 [PruneSpec("mlp/wu", consumers=("mlp/wd",)),
                  PruneSpec("mlp/wd", can_permute_rows=False)])
    return {"enc": attn_specs("attn") + mlp_specs,
            "dec": attn_specs("attn") + attn_specs("xattn") + mlp_specs}
