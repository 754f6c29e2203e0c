"""Family dispatch (port of `repro.models.zoo`) — the dense family only.

  init(cfg, generator, device)            -> model
  forward(model, cfg, tokens)             -> pre-logits (B, S, D)
  logits_fn(model, cfg, x)                -> vocab projection
  make_cache(cfg, batch, max_seq, ...)    -> decode cache
  prefill / decode_step                   -> serving
  verify_step / cache_rollback / cache_position -> speculative decoding
  pack_params / unpack_params             -> serve-time weight format
  hinm_plan(cfg) / perm_graph(cfg)        -> prune specs / their PermGraph
"""
from __future__ import annotations

from repro_torch.core import packing
from repro_torch.core.types import PackedHiNM
from repro_torch.models import module as M
from repro_torch.models import transformer

_FAMILY = {"dense": transformer}


def model_for(cfg):
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise KeyError(f"family {cfg.family!r} is not ported yet; see ROADMAP.md "
                       "(Queue 1 item 8)") from None


def init(cfg, generator=None, device="cuda"):
    return model_for(cfg).init(cfg, generator, device)


def forward(model, cfg, tokens, backend: str = "auto"):
    return model_for(cfg).forward(model, cfg, tokens, backend)


def logits_fn(model, cfg, x):
    return model_for(cfg).logits_fn(model, x)


def make_cache(cfg, batch: int, max_seq: int, dtype=None, **kw):
    return model_for(cfg).make_cache(cfg, batch, max_seq, dtype=dtype, **kw)


def prefill(model, cfg, tokens, cache, n_rows=None, backend: str = "auto"):
    return model_for(cfg).prefill(model, cfg, tokens, cache, n_rows, backend)


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


def cache_rollback(cfg, cache, undo, pos0, keep, n_written):
    """Commit/rollback after a verify, in place: keep `keep (B,)` of the
    `n_written` speculative rows per slot and rewind the position counters
    to `pos0 + keep`."""
    return model_for(cfg).cache_rollback(cfg, cache, undo, pos0, keep, n_written)


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
    HiNM-sparse is magnitude-pruned by the packing itself."""
    for lin in _planned_linears(cfg, model):
        if not isinstance(lin.w, PackedHiNM):
            lin.set_weight(packing.pack(lin.w.T, cfg.hinm))  # stored (n_in, n_out)
    return model


def unpack_params(cfg, model):
    """The masked-dense serving mode: every planned projection's PackedHiNM
    weight back to its (n_in, n_out) stored form, in place, so `linear`
    runs plain matmuls on the same numbers."""
    for lin in _planned_linears(cfg, model):
        if isinstance(lin.w, PackedHiNM):
            lin.set_weight(packing.unpack(lin.w).T.contiguous())
    return model
