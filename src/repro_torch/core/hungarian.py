"""Offline combinatorial solvers used by gyro-permutation (port of
`repro.core.hungarian`; numpy and scipy, no torch).

- `linear_sum_assignment`: Hungarian assignment through scipy's C
  implementation (releases the GIL, so the search's worker threads solve
  in parallel).
- `balanced_kmeans`: K-means with exact equal-size clusters, solved by
  turning the assignment step into a Hungarian problem over
  (points x cluster-slots) — the clustering used by the OCP phase.

The port keeps its own copy so that it imports nothing of the reference;
the same generator gives the same draws and the same labels.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment as _scipy_lsa

# centroids per block of the distance matrix: bounds the (P, c, d) f64
# temporary (the reference builds it for every centroid at once, 2.6 GB
# at the full-width gate projection); each entry is summed over the same
# d values in the same order, so the result is bit-equal
_D2_CENTROIDS = 8


def linear_sum_assignment(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Minimum-cost perfect matching on a square cost matrix."""
    cost = np.asarray(cost)
    if cost.ndim != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(f"square cost matrix required, got {cost.shape}")
    r, c = _scipy_lsa(cost)
    return np.asarray(r), np.asarray(c)


def _sq_dists(points: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """(P, d) x (C, d) -> (P, C) squared distances, in centroid blocks."""
    return np.concatenate(
        [((points[:, None, :] - centroids[None, c:c + _D2_CENTROIDS, :]) ** 2).sum(-1)
         for c in range(0, centroids.shape[0], _D2_CENTROIDS)], axis=1)


def balanced_kmeans(
    points: np.ndarray,
    n_clusters: int,
    rng: np.random.Generator,
    n_iters: int = 8,
) -> np.ndarray:
    """Equal-size K-means. points: (P, d) with P % n_clusters == 0.

    Returns labels (P,) with exactly P / n_clusters points per cluster.
    The balanced assignment step replicates each centroid `capacity` times
    and solves a Hungarian matching of points to centroid slots.
    """
    points = np.asarray(points, dtype=np.float64)
    n_pts = points.shape[0]
    if n_pts % n_clusters != 0:
        raise ValueError(f"{n_pts} points not divisible by {n_clusters} clusters")
    cap = n_pts // n_clusters
    if n_clusters == 1:
        return np.zeros(n_pts, dtype=np.int64)

    centroids = points[rng.choice(n_pts, size=n_clusters, replace=False)]
    labels = np.zeros(n_pts, dtype=np.int64)
    for _ in range(n_iters):
        slot_cost = np.repeat(_sq_dists(points, centroids), cap, axis=1)  # (P, C*cap)
        _, cols = linear_sum_assignment(slot_cost)
        new_labels = cols // cap
        if np.array_equal(new_labels, labels):
            labels = new_labels
            break
        labels = new_labels
        for c in range(n_clusters):
            centroids[c] = points[labels == c].mean(axis=0)
    return labels
