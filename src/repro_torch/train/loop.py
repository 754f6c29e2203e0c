"""Fault-tolerant training loop (port of `repro.train.loop`).

  - resume from ``latest`` on start-up, skipping the batches the saved
    steps consumed (elastic: leaves are restored onto the state's
    devices);
  - periodic async checkpoints (I/O overlaps the next steps) and a final
    one;
  - per-step retry: a transient failure re-runs the step; a second one
    restores the last checkpoint and SKIPS the offending batch (the
    standard poison-batch mitigation); ``recover=False`` lets a failure
    raise instead (a sharded step's collectives);
  - straggler detection: a step slower than `straggler_factor` x the
    rolling median calls `on_straggler`;
  - gradual HiNM pruning through a schedule callback that swaps the mask
    tree at pruning events (`train.gradual`).

Steps are timed on the host clock around `step_fn`, which returns once
its work is queued; a device-bound step shows as the next step's wait.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0
    max_retries: int = 1
    log_every: int = 10
    # False: a failing step raises instead of being retried or skipped (a
    # sharded step holds collectives, which no rank may step past)
    recover: bool = True


@dataclasses.dataclass
class LoopState:
    params: Any
    opt_state: Any
    masks: Any
    step: int = 0
    comp_error: Any = None


def run(
    state: LoopState,
    step_fn: Callable,
    batch_iter,
    cfg: LoopConfig,
    on_step: Callable[[int, dict], None] | None = None,
    on_straggler: Callable[[int, float], None] | None = None,
    mask_schedule: Callable[[int, LoopState], Any] | None = None,
    fail_injector: Callable[[int], None] | None = None,
) -> LoopState:
    mgr = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)

    # ---- elastic resume
    restorable = {"params": state.params, "opt_state": state.opt_state,
                  "masks": state.masks}
    restored, ckpt_step = mgr.restore_latest(restorable)
    if restored is not None:
        state.params = restored["params"]
        state.opt_state = restored["opt_state"]
        state.masks = restored["masks"]
        state.step = ckpt_step + 1
        log.info("resumed from checkpoint at step %d", ckpt_step)

    times: list[float] = []
    it = iter(batch_iter)
    consumed = state.step  # deterministic pipeline: skip consumed batches
    for _ in range(consumed):
        next(it)

    while state.step < cfg.total_steps:
        batch = next(it)
        if mask_schedule is not None:
            new_masks = mask_schedule(state.step, state)
            if new_masks is not None:
                state.masks = new_masks
        t0 = time.time()
        attempt = 0
        while not cfg.recover:
            out = step_fn(state.params, state.opt_state, state.masks, batch, state.step,
                          state.comp_error)
            state.params, state.opt_state, metrics = out[0], out[1], out[2]
            state.comp_error = out[3] if len(out) > 3 else None
            break
        while cfg.recover:
            try:
                if fail_injector is not None:
                    fail_injector(state.step)
                out = step_fn(state.params, state.opt_state, state.masks,
                              batch, state.step, state.comp_error)
                state.params, state.opt_state, metrics = out[0], out[1], out[2]
                state.comp_error = out[3] if len(out) > 3 else None
                break
            except Exception as e:  # noqa: BLE001
                attempt += 1
                log.warning("step %d failed (attempt %d): %r", state.step, attempt, e)
                if attempt <= cfg.max_retries:
                    continue
                # restore-and-skip: reload last checkpoint, skip this batch
                restored, ckpt_step = mgr.restore_latest(restorable)
                if restored is not None:
                    state.params = restored["params"]
                    state.opt_state = restored["opt_state"]
                    state.masks = restored["masks"]
                    log.warning("restored step-%d checkpoint; skipping batch %d",
                                ckpt_step, state.step)
                metrics = {"loss": float("nan"), "skipped": True}
                break

        dt = time.time() - t0
        if times and dt > cfg.straggler_factor * float(np.median(times)):
            log.warning("straggler: step %d took %.2fs (median %.2fs)",
                        state.step, dt, float(np.median(times)))
            if on_straggler is not None:
                on_straggler(state.step, dt)
        times.append(dt)
        if len(times) > 50:
            times.pop(0)

        if on_step is not None:
            on_step(state.step, {k: (float(v) if hasattr(v, "item") else v)
                                 for k, v in metrics.items()})
        if state.step % cfg.log_every == 0:
            loss = metrics.get("loss")
            log.info("step %d loss %.4f (%.2fs)", state.step,
                     float(loss) if loss is not None else float("nan"), dt)
        if state.step > 0 and state.step % cfg.checkpoint_every == 0:
            mgr.save_async({"params": state.params, "opt_state": state.opt_state,
                            "masks": state.masks}, state.step)
        state.step += 1

    mgr.save_async({"params": state.params, "opt_state": state.opt_state,
                    "masks": state.masks}, state.step - 1)
    mgr.wait()
    return state
