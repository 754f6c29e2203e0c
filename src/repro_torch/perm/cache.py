"""Saliency-hash permutation cache (port of `repro.perm.cache`).

Keyed on the exact bytes of the saliency matrices plus everything else that
determines a search result (HiNM config, method, iteration budgets, row
freedom). Repeated `prune_model` calls over unchanged weights skip the gyro
search entirely.  Saliency tensors are hashed through numpy copies on the
host.

The RNG stream is deliberately NOT part of the key: two searches over
byte-identical saliency are the same problem, and any cached answer is a
valid answer for both.
"""
from __future__ import annotations

import collections
import hashlib
import threading

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _hash_array(a) -> str:
    a = np.ascontiguousarray(_host(a))
    h = hashlib.sha1(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def search_key(sal, sal_rows, hcfg, *, method: str, can_permute_rows: bool,
               row_blocks: int, ocp_iters: int, icp_iters: int) -> tuple:
    sal_h = _hash_array(sal)
    rows_h = sal_h if sal_rows is sal else _hash_array(sal_rows)
    return (sal_h, rows_h, hcfg.v, hcfg.n, hcfg.m, hcfg.vector_sparsity,
            method, can_permute_rows, row_blocks, ocp_iters, icp_iters)


class PermCache:
    """Thread-safe LRU of (out_perm, col_order) search results."""

    def __init__(self, maxsize: int = 4096):
        self.maxsize = maxsize
        self._store: collections.OrderedDict[tuple, tuple] = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple):
        with self._lock:
            hit = self._store.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            out_perm, col_order = hit
        return out_perm.copy(), col_order.copy()

    def put(self, key: tuple, out_perm: np.ndarray, col_order: np.ndarray):
        with self._lock:
            self._store[key] = (np.asarray(out_perm).copy(),
                                np.asarray(col_order).copy())
            self._store.move_to_end(key)
            while len(self._store) > self.maxsize:
                self._store.popitem(last=False)

    def __len__(self) -> int:
        return len(self._store)

    def clear(self):
        with self._lock:
            self._store.clear()
            self.hits = self.misses = 0
