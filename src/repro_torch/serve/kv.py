"""Slot-pooled KV cache for continuous batching (port of `repro.serve.kv`):
paged pool and stripe mode, single device.

Paged mode: each cache leaf that would hold one ``max_seq`` stripe per
slot is one shared physical page buffer plus a per-slot block table.
Pages flow through a host-side free list; a slot holds
``ceil(min(prompt + max_new, view) / page)`` pages.  Page ownership is
counted per page (a slot's table entry holds one reference; sharing waits
for the prefix-sharing slice), and the free list holds exactly the pages
with no reference: ``n_free_pages + n_referenced_pages == n_alloc_pages``
at all times.  Releasing a slot sweeps its freed pages' ``kpos`` rows to
the sentinel, so a recycled page never leaks rows into a new lane.

``n_pages``: an int is the allocatable page count; ``"auto"`` provisions
for ~half-view average occupancy, floored at one full view; ``None``
provisions full stripe capacity.

Stripe mode (``page=None``): each lane pins a full ``max_seq`` stripe.

The pool is updated in place where the reference donated its buffers,
and `reset_all` fills the same storage: the scheduler's captured CUDA
graphs hold the leaves' addresses.  Host-built tables reach the device
through pinned memory (`device.to_device`), so admission and release never
wait for a decode chunk in flight.
``slot_len`` mirrors each slot's actual cache rows; ``slot_capacity`` is
the row reservation made at insert.  ``rollback`` commits a speculative
verify's accepted rows and sweeps the rest; ``rollback_sweeps`` counts the
sweeps applied to the pool.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.models import paging, zoo

# the pristine value of each cache leaf (`zoo.make_cache`); 0 elsewhere
_PRISTINE = {"kpos": paging.KPOS_SENTINEL, "bt": paging.SENTINEL_PAGE}


class SlotKVCache:
    def __init__(self, cfg, n_slots: int, max_seq: int, dtype=None,
                 page: int | None = None, n_pages: int | str | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = torch.device(device)
        self._cache_kw = dict(dtype=dtype, device=self.device)
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

    def slot_capacity(self, slot: int) -> int:
        """Cache rows reserved for `slot` at insert time."""
        return int(self._slot_cap[slot])

    def slot_pages(self, slot: int) -> list[int]:
        """Physical pages backing `slot`, block-table order."""
        return list(self._slot_pages.get(slot, ()))

    def pool_bytes(self) -> int:
        """Device bytes held by the pool cache."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    # -- slot lifecycle -------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError("no free slots")
        return self._free.pop(0)

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
            pages = [self._free_pages.popleft() for _ in range(n_alloc)]
            self._page_ref[pages] = 1
            ids = np.full((self.n_bt,), paging.SCRATCH_PAGE, np.int32)
            bt_row = np.full((self.n_bt,), paging.SENTINEL_PAGE, np.int32)
            ids[:n_alloc] = bt_row[:n_alloc] = pages
            zoo.paged_insert(self.cfg, self.cache, cache, slot, row,
                             to_device(torch.from_numpy(ids), self.device),
                             to_device(torch.from_numpy(bt_row), self.device), n_alloc)
            self._slot_pages[slot] = pages
        else:
            for name, leaf in self.cache.items():
                leaf[:, slot] = cache[name][:, row].to(leaf.dtype)
        self._slot_cap[slot] = reserve
        self.slot_len[slot] = length

    def release(self, slot: int) -> None:
        """Reset `slot` to pristine state and return it to the free lists;
        in paged mode each of its pages drops its reference, and pages left
        with none are swept (kpos back to the sentinel) and freed."""
        if self.paged:
            freed = []
            for p in self._slot_pages.pop(slot, []):
                assert self._page_ref[p] >= 1, f"page {p} double-freed"
                self._page_ref[p] -= 1
                if self._page_ref[p] == 0:
                    freed.append(p)
            ids = np.full((self.n_bt,), paging.SCRATCH_PAGE, np.int32)
            ids[: len(freed)] = freed
            zoo.paged_release(self.cfg, self.cache, slot,
                              to_device(torch.from_numpy(ids), self.device))
            self._free_pages.extend(freed)
        else:
            pristine = self.template(1)
            for name, leaf in self.cache.items():
                leaf[:, slot] = pristine[name][:, 0]
        self.slot_len[slot] = 0
        self._slot_cap[slot] = 0
        self._free.append(slot)

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

    def note_scan_rollbacks(self, n: int) -> None:
        """Count `n` rollback sweeps the scheduler's fused loop applied
        through `zoo.cache_rollback` itself, so ``rollback_sweeps`` means
        "sweeps applied to the pool" in both modes."""
        self.rollback_sweeps += n

    def reset_all(self) -> None:
        """Every slot and page free, the pool pristine: allocated on the
        first call, filled in place after."""
        if self.cache is None:
            kw = (dict(page=self.page, n_pages=self.n_pages) if self.paged else {})
            self.cache = zoo.make_cache(self.cfg, self.n_slots, self.max_seq, **kw,
                                        **self._cache_kw)
        else:
            for name, leaf in self.cache.items():
                leaf.fill_(_PRISTINE.get(name, 0))
        if self.paged:
            self._free_pages = collections.deque(range(paging.N_RESERVED, self.n_pages))
            self._page_ref[:] = 0
            self._slot_pages: dict[int, list[int]] = {}
        self._free = list(range(self.n_slots))
        self.slot_len = np.zeros((self.n_slots,), np.int64)
        self._slot_cap = np.zeros((self.n_slots,), np.int64)
        self.rollback_sweeps = 0
