"""Phase 1 — permutation search for one projection, HiNM orientation
(port of `repro.perm.search`).

Shared by `train.pruning` and `core.api.prune_matrix`. Methods:

  gyro      : annealed-sampling OCP + Hungarian ICP (the paper's algorithm)
  ocp_only / icp_only / noperm : ablations of the two phases
  v1        : OVW-style one-shot k-means OCP + our ICP   (baseline HiNM-V1)
  v2        : our OCP + Apex-style greedy swap ICP       (baseline HiNM-V2)

OCP runs on `sal_rows` (the search saliency, optionally extended with tied
partners' columns so the shared row perm is chosen jointly), per contiguous
row block when the node is block-diagonal constrained. ICP then runs on the
row-permuted `sal`.  Saliency is a float32 tensor; the cost evaluations run
on its device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import baselines, gyro
from repro_torch.core.types import HiNMConfig
from repro_torch.perm.cache import PermCache, search_key

METHODS = ("gyro", "noperm", "icp_only", "ocp_only", "v1", "v2")


def search_projection(
    sal: torch.Tensor,
    sal_rows: torch.Tensor,
    hcfg: HiNMConfig,
    *,
    method: str = "gyro",
    can_permute_rows: bool = True,
    row_blocks: int = 1,
    rng: np.random.Generator | None = None,
    ocp_iters: int = 8,
    icp_iters: int = 8,
    cache: PermCache | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Search on (n_out, n_in) saliency. Returns (out_perm, col_order).

    `col_order` is (T, K): absolute kept-column ids per tile in ICP order —
    exactly the vec_idx the packed format stores.
    """
    rng = rng or np.random.default_rng(0)
    n_out = sal.shape[0]
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")

    key = None
    if cache is not None:
        key = search_key(sal, sal_rows, hcfg, method=method,
                         can_permute_rows=can_permute_rows,
                         row_blocks=row_blocks, ocp_iters=ocp_iters,
                         icp_iters=icp_iters)
        hit = cache.get(key)
        if hit is not None:
            return hit

    run_ocp = can_permute_rows and method in ("gyro", "ocp_only", "v1", "v2")
    run_icp = method in ("gyro", "icp_only", "v1", "v2")

    if run_ocp:
        padded = torch.nn.functional.pad(sal_rows, (0, (-sal_rows.shape[1]) % hcfg.m))
        bs = n_out // row_blocks
        perms = []
        for b in range(row_blocks):
            blk = padded[b * bs : (b + 1) * bs]
            if method == "v1":
                p = baselines.ovw_ocp(blk, hcfg, rng)
            else:
                p, _ = gyro.ocp(blk, hcfg, iters=ocp_iters, rng=rng)
            perms.append(p + b * bs)
        out_perm = np.concatenate(perms)
    else:
        out_perm = np.arange(n_out)

    sal_p = sal[gyro.as_index(out_perm, sal)]
    if run_icp and method == "v2":
        col_ids, gathered = gyro._kept_gathered(sal_p, hcfg)
        col_order = np.empty_like(col_ids)
        for ti in range(col_ids.shape[0]):
            col_order[ti] = col_ids[ti][baselines.apex_icp_tile(gathered[ti], hcfg, rng)]
    else:
        res = gyro.gyro_permute(sal_p, hcfg, icp_iters=icp_iters, rng=rng,
                                run_ocp=False, run_icp=run_icp)
        col_order = res.col_order

    col_order = np.asarray(col_order, dtype=np.int32)
    if cache is not None:
        cache.put(key, out_perm, col_order)
    return out_perm, col_order
