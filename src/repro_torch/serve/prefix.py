"""Host-side radix index over token prefixes -> refcounted physical pages
(port of `repro.serve.prefix`).

The index is a trie at page granularity: each node stands for one full
page of tokens (a tuple of ``page`` ids) extending its parent's prefix, and
carries the physical page whose K/V rows hold exactly those tokens at
exactly those positions.  A K/V row of a pure-attention stack is a
per-(token, position) projection, so identical prefixes at identical
positions cache identical rows (`zoo.supports_prefix_share` gates the
families where that holds).

Ownership:

  * every node holds one reference on its page for as long as it is
    indexed, so a page can outlive every slot that wrote or mapped it
    (retention) and a later request can hit it;
  * ``match`` walks full-page children and returns the shared chain plus
    the best divergent tail (longest common prefix within the next page)
    for copy-on-write;
  * ``register`` indexes a prefilled slot's full prompt pages (only pages
    whose every row is prompt: decode rows never share);
  * ``evict`` drops least-recently-used leaves whose page only the index
    references, unwinding chains bottom-up until enough pages return to
    the free list.

The index never touches device memory: it tracks page ids, and the pool's
refcounts (`SlotKVCache.ref_pages` / `deref_pages`) decide when a page's
kpos rows are swept back to the sentinel.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PrefixMatch:
    """Result of a trie walk for one prompt."""
    page_ids: list[int]            # full shared pages, prefix order
    shared_rows: int               # full-page rows (len(page_ids) * page)
    cow_src: int | None = None     # divergent tail page to copy, if any
    cow_rows: int = 0              # rows of cow_src that match the prompt

    @property
    def total_rows(self) -> int:
        return self.shared_rows + self.cow_rows


class _Node:
    __slots__ = ("block", "page_id", "parent", "children", "last_used")

    def __init__(self, block, page_id, parent):
        self.block = block          # the page-sized token tuple this adds
        self.page_id = page_id
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.last_used = 0


class PrefixIndex:
    def __init__(self, page: int):
        self.page = page
        self._root = _Node((), -1, None)
        self._clock = 0
        self.n_pages = 0            # nodes (= index-referenced pages)
        self.evictions = 0          # pages dropped under free-list pressure
        # the reference's flight-recorder events (prefix_match,
        # prefix_register, prefix_evict) come with ROADMAP Queue 1 item 7

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup --------------------------------------------------------------

    def match(self, tokens, max_rows: int) -> PrefixMatch:
        """Longest indexed prefix of ``tokens``, capped at ``max_rows``
        (admission always prefills at least one row, whose logits give the
        first token: the cap is prompt_len - 1).  Full-page hits walk the
        trie; the first divergence point may add a copy-on-write tail, the
        child page sharing the longest common prefix within the next page
        of tokens."""
        page = self.page
        node, ids, i = self._root, [], 0
        while i + page <= len(tokens) and (i + page) <= max_rows:
            child = node.children.get(tuple(int(t) for t in tokens[i:i + page]))
            if child is None:
                break
            child.last_used = self._tick()
            ids.append(child.page_id)
            node = child
            i += page
        cow_src, cow_rows, donor = None, 0, None
        tail = tuple(int(t) for t in tokens[i:i + page])
        if tail:
            for child in node.children.values():
                j = 0
                while (j < len(tail) and j < len(child.block)
                       and child.block[j] == tail[j]):
                    j += 1
                j = min(j, max_rows - i)
                if j > cow_rows:
                    cow_src, cow_rows, donor = child.page_id, j, child
            if donor is not None:
                # touching the donor keeps a hot divergence point resident
                donor.last_used = self._tick()
        return PrefixMatch(ids, i, cow_src, cow_rows)

    # -- registration --------------------------------------------------------

    def register(self, tokens, page_ids, kv) -> int:
        """Index the full-page chain of ``tokens``: logical page p of the
        prompt is backed by physical ``page_ids[p]``.  Each new node takes
        one reference on its page (`kv.ref_pages`), the retention reference
        that lets the page outlive its writing slot.  Pages already indexed
        under the same chain (a duplicate prompt) are only touched; their
        physical twin stays owned by the slot alone.  Returns the number of
        pages newly indexed."""
        page = self.page
        node, new = self._root, 0
        for p in range(len(tokens) // page):
            block = tuple(int(t) for t in tokens[p * page:(p + 1) * page])
            child = node.children.get(block)
            if child is None:
                child = _Node(block, int(page_ids[p]), node)
                node.children[block] = child
                kv.ref_pages([child.page_id])
                self.n_pages += 1
                new += 1
            child.last_used = self._tick()
            node = child
        return new

    # -- eviction ------------------------------------------------------------

    def _leaves(self):
        stack, out = list(self._root.children.values()), []
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def _drop(self, node: _Node, kv) -> int:
        del node.parent.children[node.block]
        self.n_pages -= 1
        self.evictions += 1
        return kv.deref_pages([node.page_id])

    def evict(self, kv, n_pages: int, protect=()) -> int:
        """Free up to ``n_pages`` pages back to ``kv``'s free list by
        dropping LRU leaves whose page only the index references (dropping
        a page a live slot still maps frees nothing, so those stay).  Chains
        unwind bottom-up: an inner node becomes a leaf once its children go.
        ``protect`` lists pages a pending admission matched but has not yet
        mapped: evicting one would free it while the admission still points
        at it, and the free list could hand it back as that very slot's
        private page.  Returns pages actually freed."""
        protect = set(protect)
        freed = 0
        while freed < n_pages:
            cands = [n for n in self._leaves()
                     if kv.page_ref(n.page_id) == 1 and n.page_id not in protect]
            if not cands:
                break
            freed += self._drop(min(cands, key=lambda n: n.last_used), kv)
        return freed

    def clear(self, kv) -> int:
        """Drop every node (every retention reference).  Pages no slot maps
        return to the free list at once; shared ones follow when their last
        slot releases.  Returns pages freed now."""
        freed = 0
        while self._root.children:
            for leaf in self._leaves():
                freed += self._drop(leaf, kv)
        return freed
