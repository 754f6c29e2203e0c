"""Gradual HiNM pruning schedule (port of `repro.train.gradual`, paper
§5.1.2).

Ramp COLUMN-VECTOR sparsity first (cubic ramp, as in Zhu & Gupta 2018),
and only once the target vector sparsity is reached switch on the N:M
stage.  At the switch (and every `refresh_perm_every` steps after it, if
set) the permutation search re-runs in virtual mode — masks in the
original layout, params untouched, so the optimizer moments stay aligned;
between refreshes the masks are recomputed for the current layout, which
is cheap.  After the switch the layout is frozen: only a refresh changes
the masks.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import sparsity
from repro_torch.core.types import HiNMConfig
from repro_torch.models import zoo
from repro_torch.train import pruning


@dataclasses.dataclass
class GradualSchedule:
    target: HiNMConfig
    start_step: int = 0
    vector_end_step: int = 100     # vector ramp completes here
    nm_step: int = 150             # N:M stage switches on here
    update_every: int = 10         # mask recompute cadence
    refresh_perm_every: int = 0    # 0 = permute once at nm_step

    def vector_sparsity(self, step: int) -> float:
        t = np.clip((step - self.start_step)
                    / max(self.vector_end_step - self.start_step, 1), 0.0, 1.0)
        return float(self.target.vector_sparsity * (1 - (1 - t) ** 3))

    def nm_active(self, step: int) -> bool:
        return step >= self.nm_step

    def config_at(self, step: int) -> HiNMConfig:
        return HiNMConfig(
            v=self.target.v, n=self.target.n, m=self.target.m,
            vector_sparsity=self.vector_sparsity(step),
        )


def _mask_for_weight(w: torch.Tensor, hcfg: HiNMConfig, nm_on: bool) -> torch.Tensor:
    """Keep-mask for one stored (n_in, n_out) weight, current layout."""
    if hcfg.vector_sparsity <= 0.0 and not nm_on:
        return torch.ones_like(w, dtype=torch.bool)
    sal = w.float().abs().T                          # (n_out, n_in)
    mask = sparsity.hinm_mask(sal, hcfg) if nm_on else sparsity.vector_mask(sal, hcfg)
    return mask.T


def _stacked_mask(w: torch.Tensor, hcfg: HiNMConfig, nm_on: bool) -> torch.Tensor:
    """`_mask_for_weight` over every leading axis of `w` (layers, and an
    expert stack's experts): the reference's nested vmap."""
    if w.dim() == 2:
        return _mask_for_weight(w, hcfg, nm_on)
    return torch.stack([_stacked_mask(wi, hcfg, nm_on) for wi in w])


def recompute_masks(params, cfg, hcfg: HiNMConfig, nm_on: bool):
    """Masks for the *current* layout (no permutation search): a bool leaf,
    stacked like its weight (``(L, n_in, n_out)``, an expert stack's
    ``(L, E, n_in, n_out)``), at every planned projection; ``None``
    elsewhere."""
    masks = T.map(lambda _: None, params)
    for key, node in zoo.perm_graph(cfg).instances():
        w = pruning.get_node(params, key, node.path)["w"]
        pruning.get_node(masks, key, node.path)["w"] = _stacked_mask(w, hcfg, nm_on)
    return masks


def make_mask_schedule(cfg, sched: GradualSchedule, method: str = "gyro"):
    """Returns a callback for `train.loop.run(mask_schedule=...)`.

    At each `update_every` step the masks are recomputed from the live
    weights at the scheduled sparsity; at `nm_step` (and every
    `refresh_perm_every` if nonzero) the permutation search re-runs through
    ``prune_model(permute_params=False)``.  Refreshes share a
    saliency-hash PermCache, so a refresh over weights whose saliency has
    not changed skips the repeated searches.  The callback keeps
    ``perm_cache`` and ``refreshes`` (step, wall seconds, PruneReport) for
    inspection.
    """
    from repro_torch.perm import PermCache

    state_cache = {"last": -1}
    perm_cache = PermCache()
    refreshes: list[dict] = []

    def schedule(step: int, loop_state):
        due = (step % sched.update_every == 0) or step == sched.nm_step
        if not due or step == state_cache["last"]:
            return None
        refresh = (step == sched.nm_step) or (
            sched.refresh_perm_every
            and sched.nm_active(step)
            and step % sched.refresh_perm_every == 0
        )
        # after the N:M switch the mask layout is frozen (a plain recompute
        # would fall back to the identity layout and discard the searched
        # permutation); only explicit perm refreshes update it
        if sched.nm_active(step) and not refresh and step > sched.nm_step:
            return None
        state_cache["last"] = step
        hcfg = sched.config_at(step)
        nm_on = sched.nm_active(step)
        if refresh and method != "noperm":
            # virtual mode: masks in the original layout, params untouched —
            # optimizer moments stay aligned across the refresh
            t0 = time.perf_counter()
            _, masks, _, report = pruning.prune_model(
                zoo.from_params(cfg, loop_state.params), cfg, method=method,
                rng=np.random.default_rng(step), permute_params=False,
                cache=perm_cache,
            )
            refreshes.append(dict(step=step, wall_s=time.perf_counter() - t0,
                                  report=report))
            return pruning.mask_tree(loop_state.params, masks)
        if hcfg.vector_sparsity <= 0.0 and not nm_on:
            return None
        return recompute_masks(loop_state.params, cfg, hcfg, nm_on)

    schedule.perm_cache = perm_cache
    schedule.refreshes = refreshes
    return schedule
