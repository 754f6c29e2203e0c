"""Shared helpers for the paged KV pool (port of `repro.models.paging`).

A paged decode cache replaces each per-slot ``(B, S, ...)`` KV stripe with
one shared physical page buffer per leaf, ``(n_pages, page, ...)``, plus a
per-slot block table ``bt (B, n_bt)`` of physical page ids and a per-slot
allocated-page count ``alloc (B,)``.

Two physical pages are reserved:

  ``SCRATCH_PAGE`` (0)  — write sink for rows outside a slot's allocation
      (idle lanes keep stepping inside a decode chunk); no block table ever
      references it.
  ``SENTINEL_PAGE`` (1) — read-only masked page every unassigned block
      table entry points at; its ``kpos`` rows stay at ``KPOS_SENTINEL``.

Freed pages keep stale K/V but their ``kpos`` rows are reset to the
sentinel on release, so a recycled page never leaks rows into a view.
With prefix sharing (serve/prefix) a physical page can appear in several
block tables at once; the kpos sweep then belongs to the refcount layer
(serve/kv): only a page whose last reference drops is swept.

Where the reference returns updated arrays (buffers donated under jit),
these helpers write the pool in place and say so.
"""
from __future__ import annotations

import torch

KPOS_SENTINEL = 2**30
SCRATCH_PAGE = 0
SENTINEL_PAGE = 1
N_RESERVED = 2


def shard_geometry(n_alloc: int, n_shards: int = 1) -> dict:
    """Total physical page count of an ``n_shards``-way sharded pool.

    The page axis is the sharded axis of every pool leaf, so the total page
    count — allocatable pages plus the two reserved ones (scratch and
    sentinel are pool-global: they live on the shard that owns ids 0/1) —
    must divide the shards.  The count is rounded up, so provisioning never
    shrinks; the padding pages join the free lists as ordinary pages.

    Returns dict(n_pages, n_alloc, pages_per_shard).
    """
    n_shards = max(1, int(n_shards))
    total = N_RESERVED + max(1, int(n_alloc))
    total = -(-total // n_shards) * n_shards
    return {"n_pages": total, "n_alloc": total - N_RESERVED,
            "pages_per_shard": total // n_shards}


def geometry(view_len: int, page: int) -> dict:
    """Resolve page geometry for a logical view of ``view_len`` rows.

    ``page`` is clamped to the view and halved until it divides it, so any
    requested size yields a valid layout. Returns dict(view, page, n_bt).
    """
    page = max(1, min(page, view_len))
    while view_len % page:
        page //= 2
    return {"view": view_len, "page": page, "n_bt": view_len // page}


def make_attn_pool(n_stack: int, n_pages: int, page: int, n_kv_heads: int,
                   head_dim: int, dtype, device) -> dict:
    """Physical page buffers for one attention stack: k/v/kpos leaves with
    the ``(B, S)`` stripe axes replaced by ``(n_pages, page)``."""
    shape = (n_stack, n_pages, page, n_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "kpos": torch.full((n_stack, n_pages, page), KPOS_SENTINEL,
                           dtype=torch.int32, device=device),
    }


def make_tables(n_stack: int, batch: int, n_bt: int, device) -> dict:
    """Pristine per-slot block table + allocation count, replicated over the
    stack axis as the reference keeps them."""
    return {
        "bt": torch.full((n_stack, batch, n_bt), SENTINEL_PAGE,
                         dtype=torch.int32, device=device),
        "alloc": torch.zeros((n_stack, batch), dtype=torch.int32, device=device),
    }


# the pristine value of an attention cache's leaves (`make_attn_pool`,
# `make_tables`, the stripe cache); 0 elsewhere
_PRISTINE = {"kpos": KPOS_SENTINEL, "bt": SENTINEL_PAGE}


def reset_attn(cache: dict) -> None:
    """Every leaf of one attention stack's cache (stripe or paged) back to
    its pristine value, in place."""
    for name, leaf in cache.items():
        leaf.fill_(_PRISTINE.get(name, 0))


def gather_view(pool: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Resolve slots' logical views through their block tables: ``pool``
    ``(n_pages, page, ...)`` gathered by ``bt (B, n_bt)`` into a contiguous
    ``(B, n_bt * page, ...)`` view (the plain realisation of the walk the
    paged-attention kernel does in-kernel)."""
    b, n_bt = bt.shape
    page = pool.shape[1]
    return pool[bt.long()].reshape((b, n_bt * page) + tuple(pool.shape[2:]))


def is_paged(cache) -> bool:
    """True for a (per-layer slice of a) paged attention cache dict."""
    return isinstance(cache, dict) and "bt" in cache


# sharding role per paged-pool leaf (`distributed.sharding.cache_specs`):
# pool leaves shard their page axis, per-slot leaves their slot axis
PAGED_ROLES = {"k": "page", "v": "page", "kpos": "page",
               "pos": "slot", "bt": "slot", "alloc": "slot"}


def paged_roles(cache: dict) -> dict:
    """Sharding-role map of one paged attention cache dict."""
    return {k: PAGED_ROLES.get(k, "slot") for k in cache}


def scatter_rows(pool: torch.Tensor, stripe: torch.Tensor, row: int,
                 scatter_ids: torch.Tensor) -> None:
    """Copy slot-row ``row`` of a striped leaf into physical pages, in place.

    pool ``(n_stack, n_pages, page, ...)``; stripe ``(n_stack, B, S, ...)``
    with ``S >= n_bt * page``; ``scatter_ids (n_bt,)`` physical ids, entries
    past the allocation pointing at SCRATCH_PAGE (duplicate scratch writes
    race benignly — scratch is unreachable by reads).
    """
    page = pool.shape[2]
    n_bt = scatter_ids.shape[0]
    one = stripe[:, row]
    pieces = one[:, : n_bt * page].reshape(
        (one.shape[0], n_bt, page) + tuple(one.shape[2:])).to(pool.dtype)
    pool[:, scatter_ids.long()] = pieces


def insert_attn(pool: dict, stripe: dict, row: int, scatter_ids, bt_row,
                n_alloc: int, slot: int) -> dict:
    """Insert a prefilled stripe-cache row into a paged attention stack, in
    place: scatter k/v/kpos pieces to their physical pages, copy the
    per-slot ``pos`` counter, and install the block table row."""
    for name in ("k", "v", "kpos"):
        scatter_rows(pool[name], stripe[name], row, scatter_ids)
    pool["pos"][:, slot] = stripe["pos"][:, row]
    pool["bt"][:, slot] = bt_row
    pool["alloc"][:, slot] = n_alloc
    return pool


def release_attn(pool: dict, page_ids, slot: int) -> dict:
    """Release a slot from a paged attention stack, in place: freed pages'
    kpos rows return to the sentinel and the slot's table/counters go
    pristine.  ``page_ids (n_bt,)`` is padded with SCRATCH_PAGE."""
    kpos = pool["kpos"]
    # the sentinel as a device fill (a Python scalar stored through an
    # index is a host-to-device copy, which waits for the whole stream)
    kpos[:, page_ids.long()] = torch.full((kpos.shape[0], page_ids.shape[0], kpos.shape[2]),
                                          KPOS_SENTINEL, dtype=kpos.dtype, device=kpos.device)
    pool["pos"][:, slot] = 0
    pool["bt"][:, slot] = SENTINEL_PAGE
    pool["alloc"][:, slot] = 0
    return pool


def map_attn(pool: dict, bt_row, n_alloc: int, pos: int, slot: int) -> dict:
    """Map a slot onto already-written physical pages, in place, with no
    scatter: install its block-table row and allocation count and set
    ``pos`` to the rows the mapped prefix already holds (prefix sharing:
    the shared pages carry another owner's rows, identical for an
    identical token prefix at identical positions).  The suffix is written
    later by extension prefill through the multi-token decode path."""
    pool["pos"][:, slot] = pos
    pool["bt"][:, slot] = bt_row
    pool["alloc"][:, slot] = n_alloc
    return pool


def copy_page(pool: dict, dst: int, src: int, keep_rows: int) -> dict:
    """Copy-on-write a divergent tail page, in place: physical page
    ``src``'s K/V rows are copied to ``dst`` and only its first
    ``keep_rows`` kpos rows come along; the donor's rows past the
    divergence land as the sentinel (masked like unwritten rows, and
    extension prefill overwrites them)."""
    for name in ("k", "v"):
        pool[name][:, dst] = pool[name][:, src]
    kpos = pool["kpos"]
    kpos[:, dst, :keep_rows] = kpos[:, src, :keep_rows]
    kpos[:, dst, keep_rows:] = KPOS_SENTINEL
    return pool


def sweep_pages(pool: dict, page_ids) -> dict:
    """Reset ``page_ids``' kpos rows to the sentinel, in place, without
    touching any slot's table (a prefix-cache eviction frees pages no
    block table references; SCRATCH_PAGE padding is never read)."""
    pool["kpos"].index_fill_(1, page_ids.long(), KPOS_SENTINEL)
    return pool


def spec_row_locations(bt: torch.Tensor, alloc: torch.Tensor, pos0: torch.Tensor,
                       n: int, page: int, window: bool):
    """Physical (page, offset) of the `n` rows written per slot from
    ``pos0`` — the addressing of single-token decode (n = 1) and of
    multi-token writes.  bt (B, n_bt), alloc (B,), pos0 (B,).  Returns
    (phys (B, n), off (B, n), valid (B, n)); ``valid`` is False where the
    row falls outside the slot's allocation (such writes go to scratch)."""
    n_bt = bt.shape[1]
    view = n_bt * page
    ar = torch.arange(n, dtype=torch.int32, device=bt.device)
    vpos = pos0[:, None] + ar[None, :]
    if window:
        vpos = torch.remainder(vpos, view)
    logical = torch.clamp(torch.div(vpos, page, rounding_mode="floor"), 0, n_bt - 1)
    off = torch.remainder(vpos, page)
    valid = torch.div(vpos, page, rounding_mode="floor") < alloc[:, None]
    phys = torch.gather(bt, 1, logical.long())
    return phys, off, valid


# ---------------------------------------------------------------------------
# speculative decoding: commit/rollback of multi-token writes
# ---------------------------------------------------------------------------
#
# A verify step writes n rows per slot from the slot's position through the
# same addressing as single-token decode (`spec_row_locations`).  Rollback
# keeps the accepted prefix and sweeps the rejected suffix's `kpos` back to
# the sentinel: the K/V bytes stay (masked exactly like unwritten rows) and
# the next verify overwrites them, so no page moves.  Both helpers write the
# cache in place and return it.


def rollback_attn_paged(pool: dict, pos0: torch.Tensor, keep: torch.Tensor, n: int,
                        window: bool) -> dict:
    """Keep ``keep`` (B,) of the ``n`` rows written from ``pos0`` (B,) in a
    paged attention stack: the rejected rows' kpos return to the sentinel
    and every layer's ``pos`` rewinds to ``pos0 + keep``.  Sweeps of kept or
    out-of-allocation rows are redirected to the scratch page (no-ops)."""
    page = pool["k"].shape[2]
    phys, off, valid = spec_row_locations(pool["bt"][0], pool["alloc"][0], pos0, n,
                                          page, window)
    drop = torch.arange(n, device=pos0.device)[None, :] >= keep[:, None]
    phys_sw = torch.where(valid & drop, phys, SCRATCH_PAGE)
    kpos = pool["kpos"]
    # the sentinel as a device tensor: a Python scalar here would be a
    # host-to-device copy per call (and cannot be captured in a CUDA graph)
    kpos[:, phys_sw.long(), off.long()] = torch.full(
        (kpos.shape[0],) + tuple(phys_sw.shape), KPOS_SENTINEL, dtype=kpos.dtype,
        device=kpos.device)
    pool["pos"][:] = (pos0 + keep).to(torch.int32)[None, :]
    return pool


def rollback_attn_stripe(cache: dict, pos0: torch.Tensor, keep: torch.Tensor, n: int,
                         window: bool) -> dict:
    """Stripe-layout twin of `rollback_attn_paged`: the rejected rows' kpos
    back to the sentinel at their stripe (or ring) slots, ``pos`` rewound.
    Rows past the stripe end, which the verify's write dropped, are
    dropped here too."""
    smax = cache["k"].shape[2]
    b = pos0.shape[0]
    ar = torch.arange(n, device=pos0.device)
    idx = pos0.to(torch.int64)[:, None] + ar[None, :]
    if window:
        idx = torch.remainder(idx, smax)
    drop = (ar[None, :] >= keep[:, None]) & (idx < smax)
    # the swept rows as a (B, smax) mask; kept and dropped-at-write rows
    # land in a spare column
    swept = torch.zeros((b, smax + 1), dtype=torch.bool, device=pos0.device)
    swept.scatter_(1, torch.where(drop, idx, smax), True)
    kpos = cache["kpos"]
    kpos.copy_(torch.where(swept[None, :, :smax], KPOS_SENTINEL, kpos))
    cache["pos"][:] = (pos0 + keep).to(torch.int32)[None, :]
    return cache


# A sequential verifier (the hybrid family's) writes its rows through S
# single-token decode steps, so on a wrapped ring a step may overwrite a
# row that is still live.  Each step first snapshots the row it is about
# to write; the rollback puts the rejected steps' snapshots back.


def _row_loc_at(cache: dict, pos: torch.Tensor, window: bool):
    """Per-slot index pair of the row a single-token decode step at
    position ``pos`` (B,) writes: (page, offset) for a paged stack (the
    scratch page outside the allocation), (lane, slot) for a stripe (the
    ring slot ``pos % smax``, or ``pos`` clamped at the stripe end, as the
    write clamps it)."""
    if is_paged(cache):
        page = cache["k"].shape[2]
        phys, off, valid = spec_row_locations(cache["bt"][0], cache["alloc"][0], pos, 1, page,
                                              window)
        return torch.where(valid, phys, SCRATCH_PAGE)[:, 0].long(), off[:, 0].long()
    smax = cache["k"].shape[2]
    idx = torch.remainder(pos, smax) if window else torch.clamp(pos, 0, smax - 1)
    return torch.arange(pos.shape[0], device=pos.device), idx.long()


def snapshot_attn_row(cache: dict, window: bool) -> dict:
    """A copy of the row the next decode step overwrites, per k/v/kpos
    leaf, (L, B, ...)."""
    i, j = _row_loc_at(cache, cache["pos"][0], window)
    return {name: cache[name][:, i, j] for name in ("k", "v", "kpos")}


def restore_attn_rows(cache: dict, snaps: dict, pos0: torch.Tensor, keep: torch.Tensor,
                      n: int, window: bool) -> dict:
    """Undo the rejected suffix of ``n`` sequential decode writes from
    ``pos0`` (B,), in place: rows of steps ``i >= keep`` return to their
    pre-step snapshots (``snaps`` leaves step-stacked ``(n, L, B, ...)``)
    and ``pos`` rewinds to ``pos0 + keep``.  Restores run in reverse step
    order, so a row written twice (the stripe end's clamp) gets back what
    its first write clobbered."""
    for i in reversed(range(n)):
        ii, jj = _row_loc_at(cache, pos0 + i, window)
        drop = i >= keep                                     # (B,)
        for name in ("k", "v", "kpos"):
            leaf = cache[name]
            cur = leaf[:, ii, jj]                            # (L, B, ...)
            mask = drop.reshape((1, -1) + (1,) * (cur.dim() - 2))
            leaf[:, ii, jj] = torch.where(mask, snaps[name][i], cur)
    cache["pos"][:] = (pos0 + keep).to(torch.int32)[None, :]
    return cache


def select_state(snaps: torch.Tensor, final: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """A per-slot recurrent state rewound to ``keep`` (B,) accepted steps:
    ``snaps`` (n, L, B, ...) holds the state before each of n verify steps,
    ``final`` (L, B, ...) the state after all n.  Returns the state after
    exactly ``keep[b]`` steps, (L, B, ...)."""
    states = torch.cat([snaps, final[None]], dim=0).movedim(2, 0)   # (B, n + 1, L, ...)
    lanes = torch.arange(states.shape[0], device=states.device)
    return states[lanes, keep.long()].movedim(0, 1)


# ---------------------------------------------------------------------------
# per-slot leaves outside the page pool (an encoder-decoder's cached
# encoder output and its length)
# ---------------------------------------------------------------------------


def copy_slot_row(dst: torch.Tensor, src: torch.Tensor, slot: int, row: int,
                  axis: int) -> torch.Tensor:
    """Copy slot-row ``row`` of striped leaf ``src`` into row ``slot`` of
    ``dst`` along ``axis``, in place (the generic insert of a leaf that is
    not paged).  Where ``src`` is narrower than ``dst`` on another axis
    (a request's encoder output shorter than the pool's ``t_enc``), it
    lands at the start of that axis and the rest of the row stays as it
    was, as the reference's `dynamic_update_slice` leaves it."""
    one = src.narrow(axis, row, 1)
    region = dst.narrow(axis, slot, 1)
    region[tuple(slice(0, n) for n in one.shape)].copy_(one.to(dst.dtype))
    return dst


def reset_slot_row(leaf: torch.Tensor, slot: int, axis: int, fill=0) -> torch.Tensor:
    """Reset one slot row of a striped (not paged) leaf to ``fill``, in
    place."""
    leaf.narrow(axis, slot, 1).fill_(fill)
    return leaf
