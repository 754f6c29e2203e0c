"""Baseline permutation/pruning strategies the paper compares against
(port of `repro.core.baselines`).

  - `ovw_ocp`        : OVW-style output-channel permutation — one-shot
                       balanced K-means over *all* output channels (no
                       sampling, no Hungarian pruning-aware assignment).
                       Used for the HiNM-V1 ablation and the OVW baseline.
  - `apex_icp_tile`  : NVIDIA-Apex-style input-channel permutation —
                       greedy column swaps between N:M partitions, adapted
                       to column-vector granularity. Used for HiNM-V2.
  - `ovw_prune`      : pure vector-wise sparsity at a given total sparsity.
  - `unstructured_retained` : element-wise magnitude pruning (upper bound).

Saliency arrives as a tensor (its device is used) or a numpy array.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import gyro, sparsity
from repro_torch.core.hungarian import balanced_kmeans
from repro_torch.core.types import GyroResult, HiNMConfig


def ovw_ocp(sal, cfg: HiNMConfig, rng: np.random.Generator) -> np.ndarray:
    """One-shot balanced K-means OCP (OVW): cluster all rows into tiles."""
    sal = gyro.as_f32(sal).cpu().numpy()
    n_out = sal.shape[0]
    p = n_out // cfg.v
    if p == 1:
        return np.arange(n_out)
    labels = balanced_kmeans(sal, p, rng)
    return np.argsort(labels, kind="stable")


def apex_icp_tile(
    tile,
    cfg: HiNMConfig,
    rng: np.random.Generator,
    max_swaps: int = 2000,
) -> np.ndarray:
    """Greedy stochastic column-swap ICP (Apex-style) on one (V, K) tile."""
    tile_t = gyro.as_f32(tile)
    v, k = tile_t.shape
    g = k // cfg.m
    order = np.arange(k)
    if g == 1:
        return order

    def part_ret(o: np.ndarray) -> float:
        grp = tile_t[:, gyro.as_index(o, tile_t)].reshape(v, g, cfg.m).transpose(0, 1)
        return float(gyro._nm_retained_groups(grp, cfg.n).sum())

    best = part_ret(order)
    for _ in range(max_swaps):
        a, b = rng.integers(0, k, size=2)
        if a // cfg.m == b // cfg.m:
            continue
        cand = order.copy()
        cand[a], cand[b] = cand[b], cand[a]
        r = part_ret(cand)
        if r > best + 1e-9:
            best, order = r, cand
    return order


def hinm_v1(sal, cfg: HiNMConfig, rng: np.random.Generator,
            icp_iters: int = 16) -> GyroResult:
    """Ablation HiNM-V1: OVW-style OCP + our ICP."""
    sal_t = gyro.as_f32(sal)
    out_perm = ovw_ocp(sal_t, cfg, rng)
    sal_p = sal_t[gyro.as_index(out_perm, sal_t)]
    col_ids, gathered = gyro._kept_gathered(sal_p, cfg)
    orders, _ = gyro.icp(gathered, cfg, iters=icp_iters)
    col_order = np.take_along_axis(col_ids, orders, axis=1)
    return gyro._finish(sal_t, sal_p, out_perm, col_order, cfg)


def hinm_v2(sal, cfg: HiNMConfig, rng: np.random.Generator,
            ocp_iters: int = 24) -> GyroResult:
    """Ablation HiNM-V2: our OCP + Apex-style swap ICP."""
    sal_t = gyro.as_f32(sal)
    out_perm, _ = gyro.ocp(sal_t, cfg, iters=ocp_iters, rng=rng)
    sal_p = sal_t[gyro.as_index(out_perm, sal_t)]
    col_ids, gathered = gyro._kept_gathered(sal_p, cfg)
    col_order = np.empty_like(col_ids)
    for ti in range(col_ids.shape[0]):
        col_order[ti] = col_ids[ti][apex_icp_tile(gathered[ti], cfg, rng)]
    return gyro._finish(sal_t, sal_p, out_perm, col_order, cfg)


def ovw_prune(sal, cfg_v: int, total_sparsity: float, rng: np.random.Generator) -> float:
    """OVW baseline: vector-only sparsity at `total_sparsity` + k-means OCP.

    Returns retained saliency fraction."""
    sal_t = gyro.as_f32(sal)
    # n=1, m=2 is a placeholder; vector-only retention only uses vector_mask
    cfg = HiNMConfig(v=cfg_v, n=1, m=2, vector_sparsity=total_sparsity)
    sal_p = sal_t[gyro.as_index(ovw_ocp(sal_t, cfg, rng), sal_t)]
    return float((sal_p * sparsity.vector_mask(sal_p, cfg)).sum() / sal_t.sum())


def unstructured_retained(sal, total_sparsity: float) -> float:
    sal_t = gyro.as_f32(sal)
    mask = sparsity.unstructured_mask(sal_t, total_sparsity)
    return float((sal_t * mask).sum() / sal_t.sum())
