"""Optimizers (port of `repro.optim.optimizers`): functional over a tree of
tensors (`repro_torch.tree`), with the reference's state structure.

- AdamW with f32 moments (``mu``, ``nu``, ``count``) and decoupled weight
  decay on every tensor, norms and biases included.
- Adafactor: factored second moment (``vr``/``vc``) for leaves of two or
  more dimensions — a layer-stacked (L, d) norm scale included — and a
  plain ``v`` otherwise, no first moment, update RMS clipping per leaf.
- Global-norm clipping and the cosine schedule with linear warm-up.

An update returns new tensors and leaves its inputs as they were, so a
failed step can be retried on the same state.  Masked params (HiNM): the
train step re-applies the masks after the update, so the optimizers stay
mask-agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import tree as T


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """lr(step) as a Python float, computed in float32 as the reference's
    schedule is."""
    f32 = np.float32

    def lr(step):
        step = f32(step)
        warm = f32(base_lr) * step / f32(max(warmup, 1))
        frac = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)), f32(0), f32(1))
        cos = f32(base_lr * 0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
        return float(warm if step < warmup else cos)

    return lr


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by min(1, max_norm / global norm); returns (grads,
    the norm as a device scalar)."""
    leaves = T.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return T.map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _unzip(structure, out, n: int) -> list:
    """Split a tree of n-tuples (one per leaf of `structure`) into n trees."""
    return [T.map(lambda _, o: o[j], structure, out) for j in range(n)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _count_like(params) -> torch.Tensor:
    dev = T.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"mu": T.map(zeros, params), "nu": T.map(zeros, params),
            "count": _count_like(params)}


# a leaf's update runs over slices of its first axis of at most this many
# elements, so its f32 temporaries stay small (a 256k x 4096 table takes
# 4.2 GB a copy); every operation is elementwise, so the numbers are the
# whole leaf's
ADAMW_SLICE = 1 << 26


def adamw_update(grads, state, params, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    count = state["count"] + 1
    c = count.float()
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c

    def part(g, mu, nu, p):
        # the reference's expressions, operation for operation; each result
        # goes into a temporary of its own (an in-place op rounds as its
        # out-of-place twin does), never into an input: an f32 leaf's
        # .float() is the leaf itself
        g32 = g.float()
        mu = (b1 * mu).add_((1 - b1) * g32)
        nu = (b2 * nu).add_((1 - b2) * g32 * g32)
        del g32
        step = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(eps))
        step.add_(weight_decay * p.float())
        return mu, nu, torch.sub(p.float(), step.mul_(lr), out=step).to(p.dtype)

    def one(g, mu, nu, p):
        if g.dim() == 0 or g.numel() <= ADAMW_SLICE:
            return part(g, mu, nu, p)
        rows = max(1, ADAMW_SLICE // (g.numel() // g.shape[0]))
        out = (torch.empty_like(mu), torch.empty_like(nu), torch.empty_like(p))
        for i in range(0, g.shape[0], rows):
            for o, r in zip(out, part(*(t[i:i + rows] for t in (g, mu, nu, p)))):
                o[i:i + rows] = r
        return out

    mu, nu, new_p = _unzip(grads, T.map(one, grads, state["mu"], state["nu"], params), 3)
    return new_p, {"mu": mu, "nu": nu, "count": count}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored second moments
# ---------------------------------------------------------------------------


def adafactor_init(params):
    def f(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
        if p.dim() >= 2:
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return {"v": T.map(f, params), "count": _count_like(params)}


def adafactor_update(grads, state, params, lr, decay=0.8, eps=1e-30, clip_thr=1.0):
    count = state["count"] + 1
    c = count.float()
    beta = 1.0 - c ** (-decay)

    def one(g, v, p):
        g32 = g.float()
        sq = g32 * g32 + eps
        if p.dim() >= 2:
            vr = beta * v["vr"] + (1 - beta) * sq.mean(dim=-1)
            vc = beta * v["vc"] + (1 - beta) * sq.mean(dim=-2)
            denom = vr.mean(dim=-1, keepdim=True)
            prec = (vr / torch.clamp(denom, min=eps))[..., None] * vc[..., None, :]
            update = g32 * torch.rsqrt(torch.clamp(prec, min=eps))
            nv = {"vr": vr, "vc": vc}
        else:
            nv = {"v": beta * v["v"] + (1 - beta) * sq}
            update = g32 * torch.rsqrt(torch.clamp(nv["v"], min=eps))
        rms = torch.sqrt(torch.mean(update * update) + 1e-12)
        update = update / torch.clamp(rms / clip_thr, min=1.0)
        return nv, (p.float() - lr * update).to(p.dtype)

    # a leaf's state is a {"vr", "vc"} or {"v"} subtree at the leaf's place
    nv, new_p = _unzip(grads, T.map(one, grads, state["v"], params), 2)
    return new_p, {"v": nv, "count": count}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state)
    name: str


def make_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return Optimizer(adamw_init, adamw_update, "adamw")
    if name == "adafactor":
        return Optimizer(adafactor_init, adafactor_update, "adafactor")
    raise ValueError(f"unknown optimizer {name!r}")
