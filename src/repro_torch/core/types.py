"""Shared dataclasses for the HiNM sparsity core (port of `repro.core.types`).

The packed HiNM format:

  vals    (T, V, Kn)  surviving weight values, ICP-permuted column order
  vec_idx (T, K)      source input-channel of each kept column-vector per tile
  nm_idx  (T, V, Kn)  slot (0..M-1) of each surviving value inside its M-group

with T = n_out / V tiles, K kept column-vectors per tile, Kn = K*N/M
surviving values per row.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HiNMConfig:
    """Static configuration of the hierarchical N:M sparsity pattern."""

    v: int = 32          # column-vector length (output-channel tile height)
    n: int = 2           # N of N:M (values kept per group)
    m: int = 4           # M of N:M (group size along kept columns)
    vector_sparsity: float = 0.5  # fraction of column-vectors pruned per tile

    def __post_init__(self) -> None:
        if self.v <= 0 or self.v % 8 != 0:
            raise ValueError(f"V must be a positive multiple of 8, got {self.v}")
        if not (0 < self.n < self.m):
            raise ValueError(f"need 0 < N < M, got N={self.n} M={self.m}")
        if not (0.0 <= self.vector_sparsity < 1.0):
            raise ValueError(f"vector_sparsity in [0,1), got {self.vector_sparsity}")

    @property
    def total_sparsity(self) -> float:
        """Overall fraction of zeroed weights, e.g. 0.75 for 50% + 2:4."""
        return 1.0 - (1.0 - self.vector_sparsity) * (self.n / self.m)

    def kept_columns(self, n_in: int) -> int:
        """K — kept column-vectors per tile; rounded to a multiple of M."""
        k = int(round(n_in * (1.0 - self.vector_sparsity)))
        k = max(self.m, (k // self.m) * self.m)
        if k > n_in:
            k = (n_in // self.m) * self.m
        return k

    def num_tiles(self, n_out: int) -> int:
        if n_out % self.v != 0:
            raise ValueError(f"n_out={n_out} not divisible by V={self.v}")
        return n_out // self.v

    def validate_shape(self, n_out: int, n_in: int) -> None:
        if n_out % self.v != 0:
            raise ValueError(f"n_out={n_out} % V={self.v} != 0")
        if n_in % self.m != 0:
            raise ValueError(f"n_in={n_in} % M={self.m} != 0")


@dataclasses.dataclass
class PackedHiNM:
    """A weight matrix in packed HiNM format (see module docstring).

    A plain dataclass of torch tensors: the layer loop of the port walks
    per-layer modules, so nothing needs the JAX pytree registration."""

    vals: torch.Tensor      # (T, V, Kn) float
    vec_idx: torch.Tensor   # (T, K) int32
    nm_idx: torch.Tensor    # (T, V, Kn) int8
    n_out: int
    n_in: int
    config: HiNMConfig

    @property
    def k(self) -> int:
        return self.vec_idx.shape[-1]

    @property
    def kn(self) -> int:
        return self.vals.shape[-1]

    @property
    def t(self) -> int:
        return self.vals.shape[0]

    def packed_bytes(self) -> int:
        """Device-memory footprint of the packed representation."""
        vb = self.vals.numel() * self.vals.element_size()
        ib = self.vec_idx.numel() * 4
        nb = self.nm_idx.numel() * 1
        return int(vb + ib + nb)

    def dense_bytes(self) -> int:
        lead = int(np.prod(self.vals.shape[:-3])) if self.vals.dim() > 3 else 1
        return int(lead * self.n_out * self.n_in * self.vals.element_size())


@dataclasses.dataclass
class GyroResult:
    """Output of a gyro-permutation search for one weight matrix."""

    out_perm: np.ndarray          # (n_out,) permutation of output channels
    col_order: np.ndarray         # (T, K) per-tile kept-column order (= vec_idx)
    retained: float               # final retained saliency  ||M . rho||
    total: float                  # total saliency  ||rho||
    history: list[float] = dataclasses.field(default_factory=list)

    @property
    def retained_fraction(self) -> float:
        return float(self.retained / max(self.total, 1e-30))
