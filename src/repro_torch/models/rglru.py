"""RG-LRU recurrent block (port of `repro.models.rglru`, Griffin,
arXiv:2402.19427): a diagonal gated linear recurrence

  r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
  a_t = a^(c * r_t)            (a = sigmoid(Lambda), per-channel)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped with in/out projections, a multiplicative gelu branch and a
short causal depthwise conv over time.  The diagonal gate parameters
(``lam``, the conv filters) are per-channel vectors, not matmuls: they
stay dense, and the five projections are HiNM-prunable but may not
permute their rows (ICP only).

The recurrence runs as a log-depth scan over time in float32 (`scan`:
Hillis–Steele, ceil(log2 S) passes of whole-sequence elementwise ops),
where the reference runs `jax.lax.associative_scan`; the two sum the
same products in different orders, so a prefill's state agrees with the
reference's to f32 rounding.  A decode step (S = 1) takes no pass.

A block takes its layer's cache as a dict of views into the stacked
state (``h`` (B, R) float32, ``conv`` (B, CONV_K - 1, R) in the cache
dtype) and writes the state it ends in there, in place; without a cache
it starts from zeros and keeps none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models.module import PruneSpec

C_SCALE = 8.0
CONV_K = 4
PROJECTIONS = ("win", "wgate", "wa", "wx", "wout")


class RGLRUBlock(nn.Module):
    def __init__(self, ln: M.Norm, win: M.Linear, wgate: M.Linear, conv: torch.Tensor,
                 wa: M.Linear, wx: M.Linear, lam: torch.Tensor, wout: M.Linear):
        super().__init__()
        self.ln, self.win, self.wgate, self.wa, self.wx, self.wout = ln, win, wgate, wa, wx, wout
        self.register_buffer("conv", conv)
        self.register_buffer("lam", lam)


def width(cfg) -> int:
    """The recurrence's channel count R."""
    return cfg.rglru_dim or cfg.d_model


def rglru_block_init(cfg, *, generator, device) -> RGLRUBlock:
    d, r = cfg.d_model, width(cfg)
    kw = dict(generator=generator, device=device)
    ln = L.norm_init(cfg, device=device)
    win, wgate = (M.dense_init(d, r, cfg.dtype, **kw) for _ in range(2))
    conv = (torch.randn((CONV_K, r), generator=generator, device=device) * 0.02).to(cfg.dtype)
    wa, wx = (M.dense_init(r, r, cfg.dtype, **kw) for _ in range(2))
    return RGLRUBlock(ln, win, wgate, conv, wa, wx,
                      torch.full((r,), 2.0, dtype=torch.float32, device=device),
                      M.dense_init(r, d, cfg.dtype, **kw))


def scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h0: a, b (B, S, R) f32,
    h0 (B, R).  An inclusive Hillis–Steele scan of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2): pass k combines each step
    with the one 2^k before it."""
    s, shift = a.shape[1], 1
    while shift < s:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        b = torch.cat([b[:, :shift], b_prev * a[:, shift:] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a_prev * a[:, shift:]], dim=1)
        shift *= 2
    return a * h0[:, None, :] + b


def rglru_block(p: RGLRUBlock, cfg, x: torch.Tensor, cache: dict | None = None,
                backend: str = "auto") -> torch.Tensor:
    """x: (B, S, D); returns x + the block's output.  cache: {"h": (B, R),
    "conv": (B, CONV_K - 1, R)}, written in place."""
    inp = L.norm(p.ln, x, cfg)
    u = M.linear(p.win, inp, backend)                              # (B, S, R)
    gate = F.gelu(M.linear(p.wgate, inp, backend).float(), approximate="tanh")
    b, s, r = u.shape
    # the short causal depthwise conv over time, from the cached last
    # CONV_K - 1 inputs (zeros without a cache)
    if cache is None:
        prev = torch.zeros((b, CONV_K - 1, r), dtype=u.dtype, device=u.device)
    else:
        prev = cache["conv"].to(u.dtype)
    hist = torch.cat([prev, u], dim=1)
    w = p.conv.float()
    uc = hist[:, 0:s].float() * w[0]
    for i in range(1, CONV_K):
        uc = uc + hist[:, i:i + s].float() * w[i]
    ucd = uc.to(u.dtype)
    rg = torch.sigmoid(M.linear(p.wa, ucd, backend).float())
    ig = torch.sigmoid(M.linear(p.wx, ucd, backend).float())
    a_t = torch.exp(-C_SCALE * F.softplus(-p.lam.float()) * rg)   # log a_t <= 0
    gated = torch.sqrt(torch.clamp(1.0 - a_t * a_t, min=1e-9)) * (ig * uc)
    h0 = (cache["h"].float() if cache is not None
          else torch.zeros((b, r), dtype=torch.float32, device=x.device))
    h = scan(a_t, gated, h0)
    y = M.linear(p.wout, (h * gate).to(x.dtype), backend)
    if cache is not None:
        cache["h"].copy_(h[:, -1])
        cache["conv"].copy_(hist[:, -(CONV_K - 1):])
    return x + y


def rglru_plan_specs(prefix: str = "") -> list[PruneSpec]:
    """The five projections, ICP only: the R channels run through
    per-channel gates (``lam``, the conv) and an elementwise product of two
    branches, so permuting a projection's rows would mean rewriting all of
    them and the vector params."""
    return [PruneSpec(f"{prefix}{name}", can_permute_rows=False) for name in PROJECTIONS]
