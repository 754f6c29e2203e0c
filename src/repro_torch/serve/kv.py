"""Slot-pooled KV cache for continuous batching (port of `repro.serve.kv`):
paged pool and stripe mode, single device.

Paged mode: each cache leaf that would hold one ``max_seq`` stripe per
slot is one shared physical page buffer plus a per-slot block table.
Pages flow through a host-side free list; a slot holds
``ceil(min(prompt + max_new, view) / page)`` pages.

Page ownership is refcounted (prefix sharing, serve/prefix): a physical
page may sit in several slots' block tables at once, and the prefix index
may retain it after every mapping slot released.  A slot's table entry and
the index's retention each hold one reference; the free list holds
exactly the pages with none, so ``n_free_pages + n_referenced_pages ==
n_alloc_pages`` at all times.  A page's ``kpos`` rows are swept to the
sentinel when its last reference drops, not when one owner releases it
(a co-owner may still attend to them), so a recycled page never leaks
rows into a new lane.  ``map_slot`` installs shared pages into a new
slot's table with no K/V movement and copies only a divergent tail page
(copy-on-write); ``deref_pages`` is the index's retention-drop hook.

``n_pages``: an int is the allocatable page count; ``"auto"`` provisions
for ~half-view average occupancy, floored at one full view; ``None``
provisions full stripe capacity.

Stripe mode (``page=None``, or a family without a page geometry, such
as a recurrent one, whatever ``page`` asks): each lane pins a full
``max_seq`` stripe, or its O(1) recurrent state.  The cache may be any
tree of the family's (a recurrent family's tuple of per-position dicts);
stripe inserts and releases walk it leaf by leaf along
`zoo.cache_batch_axes`.

``cache_kw`` goes to `zoo.make_cache` as it is: an encoder-decoder's
``t_enc``, the encoder-output width every slot keeps beside its decoder
rows (leaves outside the page pool, inserted and reset per slot).

The pool is updated in place where the reference donated its buffers,
and `reset_all` fills the same storage with the family's pristine values
(`zoo.reset_cache`): the scheduler's captured CUDA graphs hold the
leaves' addresses.  Host-built tables reach the device
through pinned memory (`device.to_device`), so admission and release never
wait for a decode chunk in flight; mapping, copy-on-write and sweeps are
eager writes on the one stream, ordered after whatever is in flight.
``slot_len`` mirrors each slot's actual cache rows; ``slot_capacity`` is
the row reservation made at insert.  ``rollback`` commits a speculative
verify's accepted rows and sweeps the rest; ``rollback_sweeps`` counts the
sweeps applied to the pool.

Observability (the reference's, from the scheduler's telemetry bundle and
flight recorder): with ``metrics=`` the pool keeps occupancy gauges
(``kv_slots_in_use``, ``kv_pool_bytes``, ``kv_free_pages`` — its ``min``
is the low-water mark —, ``kv_pages_in_use``, ``kv_shared_pages``) and
counters (``kv_rollback_sweeps``, ``kv_cow_copies``) on every host-side
accounting change; with ``flight=`` each page decision lands as a
``kv_acquire`` / ``kv_insert`` / ``kv_map`` / ``kv_ref`` / ``kv_deref`` /
``kv_release`` event built from host state alone (``flight_label`` tags a
second pool's events).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.device import to_device
from repro_torch.models import paging, zoo

class SlotKVCache:
    def __init__(self, cfg, n_slots: int, max_seq: int, dtype=None,
                 page: int | None = None, n_pages: int | str | None = None,
                 device="cuda", metrics=None, metrics_labels=None, flight=None,
                 flight_label: str | None = None, **cache_kw):
        self._flight = flight
        self._flight_pool = flight_label
        self._m_slots = self._m_free_pages = self._m_used_pages = None
        self._m_rollbacks = self._m_shared = self._m_cow = None
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = torch.device(device)
        self._cache_kw = dict(cache_kw, dtype=dtype, device=self.device)
        geom = zoo.page_geometry(cfg, max_seq, page) if page else None
        self.paged = geom is not None
        if self.paged:
            self.page = geom["page"]
            self.view_len = geom["view"]
            self.n_bt = geom["n_bt"]
            if n_pages == "auto":
                alloc_req = max(self.n_bt, n_slots * ((self.n_bt + 1) // 2))
            elif n_pages is None:
                alloc_req = n_slots * self.n_bt  # full stripe capacity
            else:
                alloc_req = int(n_pages)
            self.n_pages = paging.N_RESERVED + max(1, alloc_req)
            self._page_ref = np.zeros((self.n_pages,), np.int64)
        self.cache = None
        self.reset_all()
        if metrics is not None:
            lb = dict(metrics_labels or {})
            self._m_slots = metrics.gauge("kv_slots_in_use", labels=lb)
            self._m_rollbacks = metrics.counter("kv_rollback_sweeps", labels=lb)
            metrics.gauge("kv_pool_bytes", labels=lb).set(self.pool_bytes())
            if self.paged:
                self._m_free_pages = metrics.gauge("kv_free_pages", labels=lb)
                self._m_used_pages = metrics.gauge("kv_pages_in_use", labels=lb)
                self._m_shared = metrics.gauge("kv_shared_pages", labels=lb)
                self._m_cow = metrics.counter("kv_cow_copies", labels=lb)
            self._observe_occupancy()

    def _emit(self, kind: str, **data) -> None:
        if self._flight is not None:
            if self._flight_pool is not None:
                data["pool"] = self._flight_pool
            self._flight.emit(kind, **data)

    def _observe_occupancy(self) -> None:
        if self._m_slots is None:
            return
        self._m_slots.set(self.n_slots - len(self._free))
        if self._m_free_pages is not None:
            free = self.n_free_pages
            self._m_free_pages.set(free)
            self._m_used_pages.set(self.n_alloc_pages - free)
            self._m_shared.set(self.n_shared_pages)

    # -- accounting -----------------------------------------------------------

    def template(self, batch: int = 1) -> dict:
        """A pristine batch-`batch` stripe cache: the prefill input (prefill
        always runs on stripes; paged insert scatters its rows into pages).
        Fresh on every call, because prefill fills it in place."""
        return zoo.make_cache(self.cfg, batch, self.max_seq, **self._cache_kw)

    def pages_needed(self, rows: int) -> int:
        """Pages covering `rows` cache rows (capped at the view)."""
        rows = min(rows, self.view_len)
        return max(1, -(-rows // self.page))

    def _pop_pages(self, n: int) -> list[int]:
        """Draw `n` free pages; each leaves with one reference, the
        caller's."""
        pages = [self._free_pages.popleft() for _ in range(n)]
        self._page_ref[pages] = 1
        return pages

    def _push_pages(self, pages) -> None:
        for p in pages:
            assert self._page_ref[p] == 0, (
                f"page {p} returned to the free list with {self._page_ref[p]} "
                "live references")
            self._free_pages.append(p)

    def _ids(self, pages) -> torch.Tensor:
        """`pages` as an (n_bt,) device id vector padded with the scratch
        page (a sweep or release of scratch is harmless: it is never read)."""
        ids = np.full((max(self.n_bt, len(pages)),), paging.SCRATCH_PAGE, np.int32)
        ids[: len(pages)] = pages
        return to_device(torch.from_numpy(ids), self.device)

    # -- page refcounts (prefix sharing) --------------------------------------

    def page_ref(self, page: int) -> int:
        """Live references of a physical page (slots mapping it plus the
        prefix index's retention)."""
        return int(self._page_ref[page])

    def ref_pages(self, pages) -> None:
        """One more reference on each page (each must be live: a page with
        none is on the free list and has nothing to share)."""
        for p in pages:
            assert self._page_ref[p] >= 1, f"page {p} is free, cannot share"
            self._page_ref[p] += 1
        if pages:
            self._emit("kv_ref", pages=[int(p) for p in pages])

    def deref_pages(self, pages) -> int:
        """Drop one reference per page.  Pages whose last reference drops
        are swept (kpos back to the sentinel: no block table and no index
        entry reaches them any more) and return to the free list.  Returns
        the number of pages freed."""
        freed = []
        for p in pages:
            assert self._page_ref[p] >= 1, f"page {p} double-freed"
            self._page_ref[p] -= 1
            if self._page_ref[p] == 0:
                freed.append(p)
        if pages:
            # `freed` is exactly the sweep set: pages whose last reference
            # just dropped
            self._emit("kv_deref", pages=[int(p) for p in pages],
                       freed=[int(p) for p in freed])
        if freed:
            zoo.paged_sweep(self.cfg, self.cache, self._ids(freed))
            self._push_pages(freed)
            self._observe_occupancy()
        return len(freed)

    @property
    def n_free_pages(self) -> int:
        return len(self._free_pages) if self.paged else 1 << 62

    @property
    def n_alloc_pages(self) -> int:
        """Total allocatable pages (excludes the two reserved pages)."""
        return self.n_pages - paging.N_RESERVED if self.paged else 1 << 62

    @property
    def n_referenced_pages(self) -> int:
        """Pages with a live reference; ``n_free_pages + n_referenced_pages
        == n_alloc_pages`` holds at every step."""
        if not self.paged:
            return 0
        return int((self._page_ref[paging.N_RESERVED:] > 0).sum())

    @property
    def n_shared_pages(self) -> int:
        """Pages with more than one live reference (mapped by several
        slots, or by a slot and the prefix index's retention)."""
        if not self.paged:
            return 0
        return int((self._page_ref[paging.N_RESERVED:] > 1).sum())

    @property
    def n_live_pages(self) -> int:
        """Distinct pages mapped by at least one live slot's block table:
        the working set.  Pages only the prefix index retains are
        reclaimable cache, not demand; sharing shrinks this number, because
        co-resident slots map the same physical pages."""
        if not self.paged:
            return 0
        return len({p for pages in self._slot_pages.values() for p in pages})

    def can_admit(self, reserve_rows: int, n_shared: int = 0) -> bool:
        """Would a request needing `reserve_rows` cache rows fit right now?
        ``n_shared`` pages of its budget come from the prefix index (a
        reference more, no free-list draw), so only the rest must be free."""
        if not self._free:
            return False
        return (not self.paged
                or self.pages_needed(reserve_rows) - n_shared <= self.n_free_pages)

    def slot_capacity(self, slot: int) -> int:
        """Cache rows reserved for `slot` at insert time."""
        return int(self._slot_cap[slot])

    def slot_pages(self, slot: int) -> list[int]:
        """Physical pages backing `slot`, block-table order."""
        return list(self._slot_pages.get(slot, ()))

    def pool_bytes(self) -> int:
        """Device bytes held by the pool cache."""
        return sum(t.numel() * t.element_size() for t in T.leaves(self.cache))

    # -- slot lifecycle -------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError("no free slots")
        slot = self._free.pop(0)
        self._emit("kv_acquire", slot=slot)
        self._observe_occupancy()
        return slot

    def insert(self, slot: int, cache: dict, length: int, row: int = 0,
               reserve: int | None = None) -> None:
        """Write row `row` of a prefilled batch-k stripe cache into `slot`.

        `length` is the row count actually written (true prompt rows);
        `reserve` is the row budget the request may grow to (prompt +
        max_new_tokens) — in paged mode it sizes the page allocation."""
        reserve = length if reserve is None else reserve
        if self.paged:
            n_alloc = self.pages_needed(reserve)
            if n_alloc > self.n_free_pages:
                raise RuntimeError(f"slot {slot}: {n_alloc} pages needed, "
                                   f"{self.n_free_pages} free")
            pages = self._pop_pages(n_alloc)
            ids = np.full((self.n_bt,), paging.SCRATCH_PAGE, np.int32)
            bt_row = np.full((self.n_bt,), paging.SENTINEL_PAGE, np.int32)
            ids[:n_alloc] = bt_row[:n_alloc] = pages
            zoo.paged_insert(self.cfg, self.cache, cache, slot, row,
                             to_device(torch.from_numpy(ids), self.device),
                             to_device(torch.from_numpy(bt_row), self.device), n_alloc)
            self._slot_pages[slot] = pages
        else:
            self._copy_rows(cache, slot, row)
        self._emit("kv_insert", slot=slot, rows=length, reserve=reserve,
                   pages=([int(p) for p in self._slot_pages[slot]] if self.paged else []))
        self._slot_cap[slot] = reserve
        self.slot_len[slot] = length
        self._observe_occupancy()

    def map_slot(self, slot: int, shared_pages, shared_rows: int, reserve: int,
                 cow_src: int | None = None, cow_rows: int = 0) -> list[int]:
        """Map `slot` onto shared prefix pages plus fresh private pages,
        with no stripe scatter (prefix sharing, serve/prefix).

        ``shared_pages`` (prefix order, ``shared_rows = len * page`` rows)
        are live pages another owner wrote: each gains a reference and lands
        in the slot's block table as it is, no K/V moves.  A divergent tail
        (``cow_src`` / ``cow_rows``) is copied onto the first fresh page,
        the donor's rows past the divergence masked out (copy-on-write).
        The slot's ``pos`` starts at the mapped row count; the caller
        prefills only the unshared suffix through the multi-token extension
        path.  Returns the slot's full page list.

        Like `insert` and `release`, these are eager writes on the current
        stream: under async admission a mapping made while a decode chunk is
        in flight is ordered after that chunk by the stream alone."""
        assert self.paged, "map_slot requires a paged pool"
        if not 0 <= cow_rows <= self.page or (cow_rows and cow_src is None):
            # a divergent tail lies within one page (`PrefixIndex.match`
            # never gives more); a longer one would claim rows no copy wrote
            raise ValueError(f"slot {slot}: a copy-on-write tail of {cow_rows} rows from "
                             f"page {cow_src} does not lie within one page of {self.page}")
        total = self.pages_needed(reserve)
        n_shared = len(shared_pages)
        n_fresh = total - n_shared
        assert n_fresh >= 1, "a mapped slot still needs >= 1 private page"
        if n_fresh > self.n_free_pages:
            raise RuntimeError(f"slot {slot}: {n_fresh} fresh pages needed, "
                               f"{self.n_free_pages} free")
        fresh = self._pop_pages(n_fresh)
        self.ref_pages(shared_pages)
        pages = list(shared_pages) + fresh
        bt_row = np.full((self.n_bt,), paging.SENTINEL_PAGE, np.int32)
        bt_row[:total] = pages
        mapped_rows = shared_rows + cow_rows
        zoo.paged_map(self.cfg, self.cache, slot,
                      to_device(torch.from_numpy(bt_row), self.device), total, mapped_rows)
        if cow_src is not None and cow_rows > 0:
            # the copy is fresh[0]: logical page n_shared, right after the
            # full shared chain
            zoo.paged_copy_page(self.cfg, self.cache, fresh[0], cow_src, cow_rows)
            self.cow_copies += 1
            if self._m_cow is not None:
                self._m_cow.inc()
        self._slot_pages[slot] = pages
        self._slot_cap[slot] = reserve
        self.slot_len[slot] = mapped_rows
        self._emit("kv_map", slot=slot, shared=[int(p) for p in shared_pages],
                   fresh=[int(p) for p in fresh],
                   cow_src=None if cow_src is None else int(cow_src),
                   cow_rows=int(cow_rows), rows=mapped_rows, reserve=reserve)
        self._observe_occupancy()
        return pages

    def release(self, slot: int) -> None:
        """Reset `slot` to pristine state and return it to the free lists.
        In paged mode each of its pages drops one reference; only pages
        whose last reference dropped are swept (kpos back to the sentinel)
        and freed: a page the prefix index retains, or another slot still
        maps, keeps its rows.  The slot's block table resets either way."""
        if self.paged:
            pages = self._slot_pages.pop(slot, [])
            freed = []
            for p in pages:
                assert self._page_ref[p] >= 1, f"page {p} double-freed"
                self._page_ref[p] -= 1
                if self._page_ref[p] == 0:
                    freed.append(p)
            zoo.paged_release(self.cfg, self.cache, slot, self._ids(freed))
            self._push_pages(freed)
            self._emit("kv_release", slot=slot, pages=[int(p) for p in pages],
                       freed=[int(p) for p in freed])
        else:
            self._copy_rows(self.template(1), slot, 0)
            self._emit("kv_release", slot=slot, pages=[], freed=[])
        self.slot_len[slot] = 0
        self._slot_cap[slot] = 0
        self._free.append(slot)
        self._observe_occupancy()

    def _copy_rows(self, src: dict, slot: int, row: int) -> None:
        """Stripe mode: every leaf's row `row` of the stripe cache `src`
        into slot `slot`, along each leaf's slot axis."""
        axes = zoo.cache_batch_axes(self.cfg, self.cache)
        for leaf, one, axis in zip(T.leaves(self.cache), T.leaves(src), T.leaves(axes)):
            paging.copy_slot_row(leaf, one, slot, row, axis)

    def rollback(self, pos0, keep, n_written: int, undo=None) -> None:
        """Speculative commit/rollback, in place: of the ``n_written`` rows a
        verify step wrote per slot from ``pos0`` (B,), keep the accepted
        ``keep`` (B,) and sweep the rest (kpos back to the sentinel; a row
        that went to the scratch page is swept there, a no-op), with every
        position counter rewound to ``pos0 + keep``.  No page moves: the
        free list, `pool_bytes` and the slot accounting are untouched (the
        caller advances ``slot_len`` by the tokens it harvests, which equal
        ``keep``).  Counts one sweep in ``rollback_sweeps``."""
        dev = self.device
        zoo.cache_rollback(self.cfg, self.cache, undo,
                           torch.as_tensor(pos0, dtype=torch.int32, device=dev),
                           torch.as_tensor(keep, dtype=torch.int32, device=dev), n_written)
        self.rollback_sweeps += 1
        if self._m_rollbacks is not None:
            self._m_rollbacks.inc()

    def note_scan_rollbacks(self, n: int) -> None:
        """Count `n` rollback sweeps the scheduler's fused loop applied
        through `zoo.cache_rollback` itself, so ``rollback_sweeps`` means
        "sweeps applied to the pool" in both modes (``kv_rollback_sweeps``
        too)."""
        self.rollback_sweeps += n
        if self._m_rollbacks is not None and n:
            self._m_rollbacks.inc(n)

    def reset_all(self) -> None:
        """Every slot and page free, the pool pristine: allocated on the
        first call, filled in place after."""
        if self.cache is None:
            kw = (dict(page=self.page, n_pages=self.n_pages) if self.paged else {})
            self.cache = zoo.make_cache(self.cfg, self.n_slots, self.max_seq, **kw,
                                        **self._cache_kw)
        else:
            zoo.reset_cache(self.cfg, self.cache)
        if self.paged:
            self._free_pages = collections.deque(range(paging.N_RESERVED, self.n_pages))
            self._page_ref[:] = 0
            self._slot_pages: dict[int, list[int]] = {}
            self.cow_copies = 0
        self._free = list(range(self.n_slots))
        self.slot_len = np.zeros((self.n_slots,), np.int64)
        self._slot_cap = np.zeros((self.n_slots,), np.int64)
        self.rollback_sweeps = 0
        self._observe_occupancy()
