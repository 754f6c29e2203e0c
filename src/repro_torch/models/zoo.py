"""Family dispatch (port of `repro.models.zoo`): the dense, MoE and vlm
families, run by the transformer module, the encoder-decoder family
(`encdec`) and the recurrent ssm family (`xlstm_model`).

  init(cfg, generator, device)            -> model
  forward(model, cfg, tokens, embeds=, remat=) -> pre-logits (B, S, D)
  params_of / from_params                 -> the reference's params tree
  logits_fn(model, cfg, x)                -> vocab projection
  make_cache(cfg, batch, max_seq, ...)    -> decode cache
  reset_cache(cfg, cache)                 -> the cache pristine, in place
  cache_batch_axes(cfg, cache)            -> slot axis per cache leaf
  prefill / decode_step                   -> serving
  verify_step / cache_rollback / cache_position -> speculative decoding
  extend_step / paged_map / paged_copy_page / paged_sweep -> prefix sharing
  pack_params / unpack_params             -> serve-time weight format
  hinm_plan(cfg) / perm_graph(cfg)        -> prune specs / their PermGraph
"""
from __future__ import annotations

from repro_torch.core import packing
from repro_torch.core.types import PackedHiNM
from repro_torch.models import module as M
from repro_torch.models import encdec, transformer, xlstm_model

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer, "encdec": encdec,
           "ssm": xlstm_model}


def model_for(cfg):
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise KeyError(f"family {cfg.family!r} is not ported yet; see ROADMAP.md "
                       "(Queue 1 item 8)") from None


def init(cfg, generator=None, device="cuda"):
    return model_for(cfg).init(cfg, generator, device)


def forward(model, cfg, tokens, embeds=None, backend: str = "auto", remat: bool = False):
    """`embeds` (B, P, D): a vlm's patch rows before the tokens, or an
    encoder-decoder's frames (required there)."""
    return model_for(cfg).forward(model, cfg, tokens, embeds, backend, remat)


def params_of(cfg, model) -> dict:
    """The dense model's tensors as the reference's params tree, layer
    leaves stacked (L, ...): the training state (`train.steps`)."""
    return model_for(cfg).params_of(model)


def from_params(cfg, params: dict):
    """A model over the params tree's own tensors (views, no copies)."""
    return model_for(cfg).from_params(cfg, params)


def logits_fn(model, cfg, x):
    return model_for(cfg).logits_fn(model, x)


def make_cache(cfg, batch: int, max_seq: int, dtype=None, **kw):
    """`kw`: ``page``/``n_pages`` (a paged pool), ``device``, and for an
    encoder-decoder ``t_enc`` (the encoder output's width a slot keeps)."""
    return model_for(cfg).make_cache(cfg, batch, max_seq, dtype=dtype, **kw)


def cache_batch_axes(cfg, cache):
    """The slot axis of each cache leaf (None for a paged pool's page
    buffers), in the cache's own structure: the slot pool inserts and
    resets stripe slots with it."""
    return model_for(cfg).cache_batch_axes(cfg, cache)


def reset_cache(cfg, cache) -> None:
    """Every leaf of `cache` back to its pristine value (`make_cache`'s),
    in place: the family defines it (a sentinel position or page, a
    recurrent state's stabiliser), so the slot pool never guesses it."""
    model_for(cfg).reset_cache(cfg, cache)


def prefill(model, cfg, tokens, cache, embeds=None, n_rows=None, backend: str = "auto"):
    """Fill a stripe cache in place; returns last-token pre-logits.  `n_rows`
    (B,) counts each lane's cache rows (a vlm's embeds rows included)."""
    return model_for(cfg).prefill(model, cfg, tokens, cache, embeds, n_rows, backend)


def decode_step(model, cfg, tokens, cache, backend: str = "auto"):
    return model_for(cfg).decode_step(model, cfg, tokens, cache, backend)


def supports_spec_decode(cfg) -> bool:
    """Whether the family has the speculative verify/rollback pair: a
    parallel verifier (pure attention) on a config without a window (a
    wrapped multi-token write would clobber live ring rows)."""
    return getattr(model_for(cfg), "SPEC_VERIFY", None) == "parallel" and not cfg.window


def verify_step(model, cfg, tokens, cache, backend: str = "auto"):
    """Speculative verify: forward `tokens (B, S)` (pending token + S-1
    drafts per slot), writing all S cache rows in place.  Returns
    (logits (B, S, vocab_padded), undo)."""
    return model_for(cfg).verify_step(model, cfg, tokens, cache, backend)


def extend_step(model, cfg, tokens, cache, backend: str = "auto"):
    """Extension prefill (chunked admission, shared-prefix suffix): write
    ``tokens (B, C)`` from each slot's position through the multi-token
    decode path, in place.  Returns (pre-logits hidden (B, C, D), undo):
    verify's twin without the vocab projection."""
    return model_for(cfg).extend_step(model, cfg, tokens, cache, backend)


def cache_rollback(cfg, cache, undo, pos0, keep, n_written):
    """Commit/rollback after a verify, in place: keep `keep (B,)` of the
    `n_written` speculative rows per slot and rewind the position counters
    to `pos0 + keep`."""
    return model_for(cfg).cache_rollback(cfg, cache, undo, pos0, keep, n_written)


def rewind_cache(cfg, cache) -> None:
    """Ready a reused stripe template for the next prefill, in place: its
    write position back to 0 (prefill writes its rows from there), or a
    recurrent family's whole state back to pristine (prefill starts from
    it)."""
    model_for(cfg).rewind_cache(cfg, cache)


def cache_position(cfg, cache):
    """Per-slot cache write position (B,) int32 (a copy)."""
    return model_for(cfg).cache_position(cfg, cache)


def supports_bucketed_prefill(cfg) -> bool:
    return getattr(model_for(cfg), "BUCKETED_PREFILL", False)


def page_geometry(cfg, max_seq: int, page: int):
    fn = getattr(model_for(cfg), "page_geometry", None)
    return None if fn is None else fn(cfg, max_seq, page)


def paged_insert(cfg, pool, stripe, slot, row, scatter_ids, bt_row, n_alloc):
    return model_for(cfg).paged_insert(cfg, pool, stripe, slot, row,
                                       scatter_ids, bt_row, n_alloc)


def paged_release(cfg, pool, slot, page_ids):
    return model_for(cfg).paged_release(cfg, pool, slot, page_ids)


def supports_prefix_share(cfg) -> bool:
    """Whether identical token prefixes cache identical K/V rows that other
    slots may map refcount-shared (serve/prefix): pure-attention stacks,
    not windowed rings (a wrapped ring reuses page rows in place)."""
    return getattr(model_for(cfg), "PREFIX_SHARE", False) and not cfg.window


def paged_map(cfg, pool, slot, bt_row, n_alloc, pos):
    """Map `slot` onto already-written physical pages (prefix sharing):
    installs `bt_row` / `n_alloc` and sets pos, in place; no K/V moves."""
    return model_for(cfg).paged_map(cfg, pool, slot, bt_row, n_alloc, pos)


def paged_copy_page(cfg, pool, dst, src, keep_rows):
    """Copy-on-write a divergent tail page, in place: K/V of `src` into
    `dst`, kpos rows past `keep_rows` landing as the sentinel."""
    return model_for(cfg).paged_copy_page(cfg, pool, dst, src, keep_rows)


def paged_sweep(cfg, pool, page_ids):
    """Sweep unreferenced pages' kpos rows to the sentinel, in place,
    without touching any slot's table (prefix-cache eviction)."""
    return model_for(cfg).paged_sweep(cfg, pool, page_ids)


def hinm_plan(cfg):
    return model_for(cfg).hinm_plan(cfg)


def perm_graph(cfg):
    """The compiled PermGraph of this architecture's `hinm_plan`."""
    from repro_torch.perm.graph import compile_model_graph

    return compile_model_graph(cfg)


def _planned_linears(cfg, model):
    """Every planned projection (tied partners included), layer by layer."""
    for key, node in perm_graph(cfg).instances():
        for blk in getattr(model, key):
            yield M.get_path(blk, node.path)


def pack_params(cfg, model):
    """Pack every planned projection's dense weight into PackedHiNM, in
    place, and return the model: from then on ``hinm_spmm`` runs the
    q/k/v/o and MLP projections of prefill and decode.  Already-packed
    weights pass through: a model pruned by `train.pruning.prune_model`
    arrives permuted and packed.  A dense weight is packed here with no
    permutation — the paper's "noperm" route — so one that is not already
    HiNM-sparse is magnitude-pruned by the packing itself.  An expert
    stack is packed expert by expert into one stacked `PackedHiNM`."""
    for lin in _planned_linears(cfg, model):
        if not isinstance(lin.w, PackedHiNM):
            lin.set_weight(packing.pack_stored(lin.w, cfg.hinm))
    return model


def unpack_params(cfg, model):
    """The masked-dense serving mode: every planned projection's PackedHiNM
    weight back to its (n_in, n_out) stored form, in place, so `linear`
    runs plain matmuls on the same numbers."""
    for lin in _planned_linears(cfg, model):
        if isinstance(lin.w, PackedHiNM):
            lin.set_weight(packing.unpack_stored(lin.w))
    return model
