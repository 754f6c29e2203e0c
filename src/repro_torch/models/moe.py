"""Top-k MoE FFN with capacity-based dispatch (port of `repro.models.moe`).

Tokens go to a fixed-capacity ``(E, C, D)`` buffer by the position each
(token, slot) takes in its expert's queue (a cumsum over expert one-hots);
a (token, slot) past its expert's capacity is dropped (Switch behaviour,
the reference's semantics).  The expert weights are stacks ``(E, d_in,
d_out)``, dense or one `PackedHiNM` whose fields lead with ``E``: each of
the three expert projections is one ``ops.hinm_matmul`` over the whole
stack, one K1 launch.

Every shape is static (the block runs inside the serve programs' CUDA
graphs): no boolean-mask indexing, ``nonzero`` or host reads; dropped rows
land in a spare buffer row that is sliced away.  A token's output does not
depend on how many rows share the call: the router's dot products, the
softmax's denominator, the top-k renormalisation and the k-sum are summed
in a fixed order (`_fixed_sum`: PyTorch's own reductions and GEMMs choose
their order from the call's shape), and the experts' K1 "rows" variant
sums each output row alone.  So a speculative verify's rows are its decode
steps' bits wherever no capacity drop parts them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import PackedHiNM
from repro_torch.models import module as M

CAPACITY_FACTOR = 1.25


class MoE(nn.Module):
    """The router (an f32 `Linear` (d_model, E)) and the SwiGLU expert
    stacks ``wg``/``wu`` (E, d_model, d_ff) and ``wd`` (E, d_ff, d_model)."""

    def __init__(self, router: M.Linear, wg: M.Linear, wu: M.Linear, wd: M.Linear):
        super().__init__()
        self.router, self.wg, self.wu, self.wd = router, wg, wu, wd


def moe_init(cfg, *, generator, device) -> MoE:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def stack(n_in, n_out):
        return M.Linear(torch.stack([M.uniform_init(n_in, n_out, cfg.dtype, generator, device)
                                     for _ in range(e)]))

    return MoE(M.dense_init(d, e, torch.float32, generator=generator, device=device),
               stack(d, f), stack(d, f), stack(f, d))


def _fixed_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over `dim` in an order set by its length alone: halve while the
    length is even (elementwise adds of the two halves), then add what is
    left from the left.  An output's bits depend on its own inputs only,
    not on the other outputs of the call."""
    dim = dim % x.dim()
    while x.shape[dim] > 1 and x.shape[dim] % 2 == 0:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    out = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        out = out + x.select(dim, i)
    return out


def capacity(nt: int, cfg, capacity_factor: float = CAPACITY_FACTOR) -> int:
    """Rows an expert's buffer holds for `nt` tokens (the reference's rule:
    a multiple of 8, at least 8)."""
    cap = int(nt * cfg.top_k * capacity_factor / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def router_probs(p: MoE, xf: torch.Tensor) -> torch.Tensor:
    """Softmax over the experts of the router's f32 logits, xf (N, D) ->
    (N, E); dot products and the denominator in `_fixed_sum`'s order."""
    w = p.router.w.float()                                   # (D, E)
    logits = _fixed_sum(xf.float()[:, None, :] * w.t()[None])
    if p.router.b is not None:
        logits = logits + p.router.b.float()
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return ex / _fixed_sum(ex)[:, None]


def route(p: MoE, x: torch.Tensor, cfg, capacity_factor: float = CAPACITY_FACTOR):
    """Routing of x (B, S, D): ``(topv, topi, pos, keep, cap)`` — the
    renormalised top-k weights and experts (N, k) (ties to the lower
    expert, as ``lax.top_k``), each (token, slot)'s position in its
    expert's queue, whether it fits the capacity, and the capacity."""
    e, k = cfg.n_experts, cfg.top_k
    nt = x.shape[0] * x.shape[1]
    probs = router_probs(p, x.reshape(nt, x.shape[-1]))
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = srt[:, :k], idx[:, :k]
    topv = topv / torch.clamp(_fixed_sum(topv), min=1e-9)[:, None]
    cap = capacity(nt, cfg, capacity_factor)
    flat = (topi.reshape(nt * k, 1) == torch.arange(e, device=x.device)).to(torch.int32)
    pos_in_e = torch.cumsum(flat, dim=0) - flat                # (N*k, E)
    pos = (pos_in_e * flat).sum(-1).reshape(nt, k)
    return topv, topi, pos, pos < cap, cap


def _expert_variant(p: MoE, b: int, cfg, capacity_factor, dtype) -> str:
    """The K1 variant a decode step over `b` slots runs on the experts (the
    dispatch's choice at its capacity), which a verify holds them to."""
    from repro_torch.kernels import hinm_spmm

    return hinm_spmm.variant(capacity(b, cfg, capacity_factor), p.wd.w, dtype)


def moe_apply(p: MoE, x: torch.Tensor, cfg, capacity_factor: float = CAPACITY_FACTOR,
              backend: str = "auto", variant: str | None = None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D).  `variant` not None marks a speculative
    verify (decode's K1 variant, `transformer.verify_step`): the experts
    then run the variant decode's capacity gets."""
    b, s, d = x.shape
    e = cfg.n_experts
    nt = b * s
    topv, topi, pos, keep, cap = route(p, x, cfg, capacity_factor)
    xf = x.reshape(nt, d)
    # scatter each kept (token, slot) to its expert's row, dropped ones to
    # the spare row e*cap: every kept row is written once, so no accumulate
    dst = torch.where(keep, topi * cap + pos, e * cap).reshape(-1)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((dst,), xf[:, None, :].expand(nt, cfg.top_k, d).reshape(-1, d))
    xe = buf[: e * cap].view(e, cap, d)
    if variant is not None and isinstance(p.wd.w, PackedHiNM):
        variant = _expert_variant(p, b, cfg, capacity_factor, x.dtype)
    gate = F.silu(M.linear(p.wg, xe, backend, variant).float())
    up = M.linear(p.wu, xe, backend, variant).float()
    out = M.linear(p.wd, (gate * up).to(x.dtype), backend, variant)      # (E, C, D)
    # gather back with the routing weights; a dropped slot reads (0, cap-1)
    # and is weighted 0, as the reference's
    src = torch.where(keep, topi * cap + pos, cap - 1).reshape(-1)
    g = out.reshape(e * cap, d).index_select(0, src)
    g = g * (topv * keep).to(g.dtype).reshape(-1, 1)
    y = _fixed_sum(g.reshape(nt, cfg.top_k, d).float(), dim=1)
    return y.to(x.dtype).reshape(b, s, d)


def aux_load_balance_loss(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean fraction * mean prob)."""
    probs = router_probs(p, x.reshape(-1, x.shape[-1]))
    top1 = probs.argmax(dim=-1)
    frac = (top1[:, None] == torch.arange(cfg.n_experts, device=x.device)).float().mean(0)
    return cfg.n_experts * (frac * probs.mean(0)).sum()
