"""Gyro-permutation (port of `repro.core.gyro`, the paper's Section 4).

Two coupled searches, run offline on a per-layer saliency matrix:

  OCP  — output-channel permutation: groups the n_out rows into tiles of V
         so that column-wise vector pruning (followed by N:M) discards as
         little saliency as possible.  Iterates {sampling -> balanced
         K-means clustering -> Hungarian assignment} with an annealed
         sample count.

  ICP  — tile-wise input-channel permutation: within each tile, permutes
         the K kept column-vectors across the K/M partitions of the N:M
         grouping so the N:M stage keeps the most saliency.  One sample
         per partition, no clustering, Hungarian assignment.

The exact Eq. (4) cost evaluations — the reference's jitted, vmapped
helpers — are batched torch functions on the saliency's device (the card
in the port's main path).  The combinatorial steps stay on the host in
numpy, as in the reference, so the same generator gives the same draws:
the tie-breaking noise, the argsorts, the k-means and the Hungarian
assignment.  Every iteration therefore goes device -> host -> device.
Saliency may be passed as a tensor (its device is used) or as a numpy
array (the CPU, unless `device` says otherwise); permutations come back
as numpy arrays.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from repro_torch.core import sparsity
from repro_torch.core.hungarian import balanced_kmeans, linear_sum_assignment
from repro_torch.core.types import GyroResult, HiNMConfig

CostMode = Literal["hinm", "vector"]

# bytes of candidate tiles per batched OCP cost evaluation; the evaluation
# holds ~4x this in temporaries
_TILE_BATCH_BYTES = {"cuda": 512 << 20, "cpu": 64 << 20}


def as_f32(sal, device=None) -> torch.Tensor:
    """Saliency (tensor or numpy) as a float32 tensor on `device`
    (default: where it lies; the CPU for numpy)."""
    if isinstance(sal, torch.Tensor):
        return sal.to(device=device or sal.device, dtype=torch.float32)
    return torch.tensor(np.asarray(sal, np.float32), device=device or "cpu")


def as_index(a, like: torch.Tensor) -> torch.Tensor:
    """A numpy permutation / index array as an int64 tensor on `like`'s
    device."""
    return torch.as_tensor(np.asarray(a, np.int64), device=like.device)


# ---------------------------------------------------------------------------
# batched cost evaluations (the reference's jit/vmap helpers)
# ---------------------------------------------------------------------------


def _keep_top(g: torch.Tensor, n: int) -> torch.Tensor:
    """Keep-mask of the top-n entries along the last axis, ties to the
    lower index — the stable descending rank `sparsity.nm_mask` takes,
    computed by an O(M^2) compare instead of two sorts."""
    m = g.shape[-1]
    i = torch.arange(m, device=g.device)
    a, b = g.unsqueeze(-1), g.unsqueeze(-2)            # self (.., M, 1), other (.., 1, M)
    beats = (b > a) | ((b == a) & (i[None, :] < i[:, None]))
    return beats.sum(-1) < n


def _tile_retained(tiles: torch.Tensor, cfg: HiNMConfig, cost_mode: str) -> torch.Tensor:
    """Retained saliency of each (V, n_in) tile under the target pattern.

    tiles: (B, V, n_in) -> (B,) retained saliency."""
    b, v, n_in = tiles.shape
    k = cfg.kept_columns(n_in)
    keep = sparsity._ranks_desc(tiles.to(torch.float32).sum(1)) < k   # (B, n_in)
    if cost_mode == "vector":
        mask = keep[:, None, :]
    else:
        cols = torch.arange(n_in, device=tiles.device).expand(b, n_in)
        col_ids = torch.sort(torch.where(keep, cols, n_in + cols), dim=-1).values[:, :k]
        idx = col_ids[:, None, :].expand(b, v, k)
        nm = _keep_top(tiles.gather(2, idx).reshape(b, v, k // cfg.m, cfg.m), cfg.n)
        mask = torch.zeros((b, v, n_in), dtype=torch.bool, device=tiles.device)
        mask.scatter_(2, idx, nm.reshape(b, v, k))
    return (tiles * mask).sum((1, 2))


def _nm_retained_groups(groups: torch.Tensor, n: int) -> torch.Tensor:
    """groups: (..., V, M) -> (...,) retained after per-row top-N of M."""
    return torch.topk(groups, n, dim=-1).values.sum((-1, -2))


def _channel_pruned_saliency(sal_perm: torch.Tensor, cfg: HiNMConfig) -> torch.Tensor:
    """Per-output-channel saliency discarded by the current HiNM mask."""
    return (sal_perm * ~sparsity.hinm_mask(sal_perm, cfg)).sum(1)


# ---------------------------------------------------------------------------
# OCP — output-channel permutation
# ---------------------------------------------------------------------------


def _sample_schedule(v: int, iters: int, s0: int | None = None) -> list[int]:
    """Annealed per-partition sample counts (learning-rate analogy)."""
    if s0 is None:
        s0 = max(1, v // 4)
    out = []
    for t in range(iters):
        frac = t / max(iters - 1, 1)
        s = int(round(s0 * (1.0 - frac) + 1 * frac))
        out.append(max(1, min(s, v)))
    return out


def _assignment_retained(base: torch.Tensor, clus: torch.Tensor, cfg: HiNMConfig,
                         cost_mode: str) -> np.ndarray:
    """(P, P) retained saliency of tile i's base rows joined with cluster
    j, every pair evaluated on the device in batches of whole rows i."""
    p, vb, n_in = base.shape
    v = vb + clus.shape[1]
    budget = _TILE_BATCH_BYTES.get(base.device.type, _TILE_BATCH_BYTES["cpu"])
    rows = max(1, budget // (p * v * n_in * 4))
    ret = torch.empty((p, p), dtype=torch.float32, device=base.device)
    for i0 in range(0, p, rows):
        bi = base[i0:i0 + rows]
        c = bi.shape[0]
        tiles = torch.cat([bi[:, None].expand(c, p, vb, n_in),
                           clus[None].expand(c, p, clus.shape[1], n_in)], dim=2)
        ret[i0:i0 + c] = _tile_retained(tiles.reshape(c * p, v, n_in), cfg,
                                        cost_mode).reshape(c, p)
    return ret.cpu().numpy()


def ocp(
    sal,
    cfg: HiNMConfig,
    iters: int = 24,
    rng: np.random.Generator | None = None,
    cost_mode: CostMode = "hinm",
    s0: int | None = None,
    patience: int = 6,
    device=None,
) -> tuple[np.ndarray, list[float]]:
    """Output-channel permutation search. Returns (perm (n_out,), history)."""
    rng = rng or np.random.default_rng(0)
    sal_t = as_f32(sal, device)
    sal_np = sal_t.cpu().numpy()          # host copy: k-means features, totals
    n_out, n_in = sal_t.shape
    cfg.validate_shape(n_out, n_in)
    v = cfg.v
    p = n_out // v

    perm = np.arange(n_out)

    def total_retained(perm_np: np.ndarray) -> float:
        tiles = sal_t[as_index(perm_np, sal_t)].reshape(p, v, n_in)
        return float(_tile_retained(tiles, cfg, cost_mode).sum())

    best = total_retained(perm)
    history = [best]
    schedule = _sample_schedule(v, iters, s0)
    stall = 0

    for s in schedule:
        if p == 1:
            break
        # ---- sampling: extract the s worst-fitting channels per partition
        sal_perm = sal_t[as_index(perm, sal_t)]
        misfit = _channel_pruned_saliency(sal_perm, cfg).cpu().numpy()
        part = perm.reshape(p, v)
        part_misfit = misfit.reshape(p, v)
        # worst-fit with random tie-noise to escape plateaus
        noise = rng.uniform(0.0, 1e-6, size=part_misfit.shape) * (part_misfit.max() + 1.0)
        extract_pos = np.argsort(-(part_misfit + noise), axis=1)[:, :s]  # (P, s)
        extracted = np.take_along_axis(part, extract_pos, axis=1)        # (P, s)
        keep_mask = np.ones((p, v), dtype=bool)
        np.put_along_axis(keep_mask, extract_pos, False, axis=1)
        bases = part[keep_mask].reshape(p, v - s)                        # (P, V-s)

        # ---- clustering: balanced k-means of the P*s samples into P groups
        samples = extracted.reshape(-1)                                  # (P*s,)
        if s == 1:
            clusters = samples.reshape(p, 1)
        else:
            labels = balanced_kmeans(sal_np[samples], p, rng)
            order = np.argsort(labels, kind="stable")
            clusters = samples[order].reshape(p, s)                      # (P, s)

        # ---- assignment: Hungarian on exact Eq.(4) cost
        totals = (sal_np[bases.reshape(-1)].reshape(p, v - s, n_in).sum(axis=(1, 2))[:, None]
                  + sal_np[clusters.reshape(-1)].reshape(p, s, n_in).sum(axis=(1, 2))[None, :])
        ret = _assignment_retained(
            sal_t[as_index(bases.reshape(-1), sal_t)].reshape(p, v - s, n_in),
            sal_t[as_index(clusters.reshape(-1), sal_t)].reshape(p, s, n_in), cfg, cost_mode)
        cost = (totals - ret).astype(np.float64)
        _, cols = linear_sum_assignment(cost)

        new_part = np.concatenate([bases, clusters[cols]], axis=1)       # (P, V)
        new_perm = new_part.reshape(-1)
        cand = total_retained(new_perm)
        if cand > best + 1e-9:
            best, perm = cand, new_perm
            stall = 0
        else:
            stall += 1
        history.append(best)
        if stall >= patience:
            break
    return perm, history


# ---------------------------------------------------------------------------
# ICP — tile-wise input-channel (column-vector) permutation
# ---------------------------------------------------------------------------


def _icp_marginals(tile: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Marginal retained saliency of each column within its M-partition.

    tile: (V, K) -> (G, M) marginal of removing each column from its group.
    Smallest marginal = most replaceable = the ICP sample."""
    v, k = tile.shape
    grp = tile.reshape(v, k // m, m).transpose(0, 1)                     # (G, V, M)
    full = _nm_retained_groups(grp, n)                                   # (G,)
    # after removing one column: keep top-N of the remaining M-1
    rets = torch.stack([_nm_retained_groups(torch.cat([grp[..., :sl], grp[..., sl + 1:]], -1), n)
                        for sl in range(m)], dim=1)                      # (G, M)
    return full[:, None] - rets


def _icp_cost_matrix(rem: torch.Tensor, cols: torch.Tensor, n: int, m: int,
                     chunk: int = 64) -> torch.Tensor:
    """Eq.(4) cost of placing extracted column j into partition i.

    rem:  (G, V, M-1) remaining columns per partition
    cols: (G, V)      extracted columns
    returns (G, G) cost = total - retained(top-N of M)."""
    g, v, _ = rem.shape
    totals = rem.sum((1, 2))[:, None] + cols.sum(1)[None, :]
    rets = []
    for i0 in range(0, g, chunk):
        r = rem[i0:i0 + chunk]
        c = r.shape[0]
        merged = torch.cat([r[:, None].expand(c, g, v, m - 1),
                            cols[None, :, :, None].expand(c, g, v, 1)], dim=-1)  # (c, G, V, M)
        rets.append(_nm_retained_groups(merged, n))
    return totals - torch.cat(rets)


def icp_tile(
    tile,
    cfg: HiNMConfig,
    iters: int = 16,
    patience: int = 4,
    device=None,
) -> tuple[np.ndarray, list[float]]:
    """Permute the K kept columns of one (V, K) tile. Returns (order, hist)."""
    tile_t = as_f32(tile, device)
    v, k = tile_t.shape
    g = k // cfg.m
    order = np.arange(k)

    def retained(o: np.ndarray) -> float:
        grp = tile_t[:, as_index(o, tile_t)].reshape(v, g, cfg.m).transpose(0, 1)
        return float(_nm_retained_groups(grp, cfg.n).sum())

    best = retained(order)
    history = [best]
    if g == 1:
        return order, history
    stall = 0
    for _ in range(iters):
        cur = tile_t[:, as_index(order, tile_t)]
        marg = _icp_marginals(cur, cfg.n, cfg.m).cpu().numpy()            # (G, M)
        extract_slot = np.argmin(marg, axis=1)                            # (G,)
        pos = order.reshape(g, cfg.m)
        extracted_pos = np.take_along_axis(pos, extract_slot[:, None], axis=1)[:, 0]
        keep = np.ones((g, cfg.m), dtype=bool)
        np.put_along_axis(keep, extract_slot[:, None], False, axis=1)
        rem_pos = pos[keep].reshape(g, cfg.m - 1)

        rem = tile_t[:, as_index(rem_pos.reshape(-1), tile_t)].reshape(v, g, cfg.m - 1)
        cols = tile_t[:, as_index(extracted_pos, tile_t)].T                   # (G, V)
        cost = _icp_cost_matrix(rem.transpose(0, 1), cols, cfg.n, cfg.m).cpu().numpy()
        _, assign = linear_sum_assignment(cost)

        new_pos = np.concatenate([rem_pos, extracted_pos[assign][:, None]], axis=1)
        new_order = new_pos.reshape(-1)
        cand = retained(new_order)
        if cand > best + 1e-9:
            best, order = cand, new_order
            stall = 0
        else:
            stall += 1
        history.append(best)
        if stall >= patience:
            break
    return order, history


def icp(
    sal_gathered,
    cfg: HiNMConfig,
    iters: int = 16,
    device=None,
) -> tuple[np.ndarray, list[float]]:
    """Run ICP on every tile. sal_gathered: (T, V, K) -> orders (T, K)."""
    sal_g = as_f32(sal_gathered, device)
    t = sal_g.shape[0]
    orders = np.empty((t, sal_g.shape[2]), dtype=np.int64)
    history: list[float] = []
    for ti in range(t):
        orders[ti], h = icp_tile(sal_g[ti], cfg, iters=iters)
        history.append(h[-1])
    return orders, history


# ---------------------------------------------------------------------------
# full gyro-permutation
# ---------------------------------------------------------------------------


def _kept_gathered(sal_p: torch.Tensor, cfg: HiNMConfig) -> tuple[np.ndarray, torch.Tensor]:
    """Default kept columns of a row-permuted saliency: (col_ids (T, K)
    ascending, numpy; the (T, V, K) saliency gathered by them)."""
    col_ids = sparsity.kept_column_ids(sal_p, cfg)
    t, k = col_ids.shape
    gathered = sal_p.reshape(t, cfg.v, -1).gather(2, col_ids.long()[:, None, :].expand(t, cfg.v, k))
    return col_ids.cpu().numpy(), gathered


def _finish(sal_t: torch.Tensor, sal_p: torch.Tensor, out_perm: np.ndarray,
            col_order: np.ndarray, cfg: HiNMConfig, history=None) -> GyroResult:
    """Retained saliency of the final layout, as a GyroResult."""
    mask = sparsity.hinm_mask_from_columns(sal_p, as_index(col_order, sal_p), cfg)
    retained = float((sal_p * mask).sum())
    if history is not None:
        history.append(retained)
    return GyroResult(out_perm=out_perm, col_order=col_order.astype(np.int32),
                      retained=retained, total=float(sal_t.sum()),
                      history=[] if history is None else history)


def gyro_permute(
    sal,
    cfg: HiNMConfig,
    ocp_iters: int = 24,
    icp_iters: int = 16,
    rng: np.random.Generator | None = None,
    cost_mode: CostMode = "hinm",
    run_ocp: bool = True,
    run_icp: bool = True,
    device=None,
) -> GyroResult:
    """Full pipeline: OCP -> vector selection -> tile-wise ICP.

    Returns a GyroResult whose `col_order` is the absolute kept-column ids in
    ICP order — i.e. exactly the `vec_idx` the packed format stores.
    """
    rng = rng or np.random.default_rng(0)
    sal_t = as_f32(sal, device)
    n_out, n_in = sal_t.shape
    cfg.validate_shape(n_out, n_in)
    history: list[float] = []

    if run_ocp:
        out_perm, h = ocp(sal_t, cfg, iters=ocp_iters, rng=rng, cost_mode=cost_mode)
        history.extend(h)
    else:
        out_perm = np.arange(n_out)

    sal_p = sal_t[as_index(out_perm, sal_t)]
    col_ids, gathered = _kept_gathered(sal_p, cfg)
    if run_icp:
        orders, _ = icp(gathered, cfg, iters=icp_iters)
        col_order = np.take_along_axis(col_ids, orders, axis=1)
    else:
        col_order = col_ids
    return _finish(sal_t, sal_p, out_perm, col_order, cfg, history)
