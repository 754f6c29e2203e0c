"""xLSTM blocks (port of `repro.models.xlstm`, arXiv:2405.04517):
alternating mLSTM and sLSTM blocks.

mLSTM — matrix-memory LSTM with exponential gating:
  C_t = f_t * C_{t-1} + i_t * (v_t k_t^T);  n_t = f_t * n_{t-1} + i_t * k_t
  h_t = (C_t q_t) / max(|n_t^T q_t|, 1)
per head, with stabilised exponential input gates.

sLSTM — scalar-memory LSTM with block-diagonal recurrent weights (one block
per head) and exponential gating.

Both recurrences run a step loop over the sequence in float32, the
reference's `lax.scan` one step at a time, as plain PyTorch ops.  The
projections (q/k/v/out, gate pre-activations) are HiNM-prunable and run
through K1 once packed; mLSTM's per-head gates (``wi``, ``wf``: d -> H)
and sLSTM's recurrent weights ``r`` stay dense.

A block takes its layer's cache as a dict of views into the stacked
state (``(B, ...)`` each) and writes the state it ends in there, in
place; without a cache it starts from the pristine state and keeps none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models.module import PruneSpec


class MLSTMBlock(nn.Module):
    def __init__(self, ln: M.Norm, wq: M.Linear, wk: M.Linear, wv: M.Linear, wi: M.Linear,
                 wf: M.Linear, wo_gate: M.Linear, wout: M.Linear):
        super().__init__()
        self.ln, self.wq, self.wk, self.wv = ln, wq, wk, wv
        self.wi, self.wf, self.wo_gate, self.wout = wi, wf, wo_gate, wout


class SLSTMBlock(nn.Module):
    def __init__(self, ln: M.Norm, wz: M.Linear, wi: M.Linear, wf: M.Linear, wo: M.Linear,
                 r: torch.Tensor, wout: M.Linear):
        super().__init__()
        self.ln, self.wz, self.wi, self.wf, self.wo, self.wout = ln, wz, wi, wf, wo, wout
        self.register_buffer("r", r)


def head_dim(cfg) -> int:
    """A head's state width: d_model // n_heads, never `cfg.head_dim` (they
    part on reduced configs)."""
    return cfg.d_model // cfg.n_heads


def mlstm_init(cfg, *, generator, device) -> MLSTMBlock:
    d, h = cfg.d_model, cfg.n_heads
    kw = dict(generator=generator, device=device)
    return MLSTMBlock(
        L.norm_init(cfg, device=device),
        M.dense_init(d, d, cfg.dtype, **kw), M.dense_init(d, d, cfg.dtype, **kw),
        M.dense_init(d, d, cfg.dtype, **kw),
        M.dense_init(d, h, cfg.dtype, bias=True, **kw),     # input gate (per head)
        M.dense_init(d, h, cfg.dtype, bias=True, **kw),     # forget gate
        M.dense_init(d, d, cfg.dtype, bias=True, **kw),
        M.dense_init(d, d, cfg.dtype, **kw))


def slstm_init(cfg, *, generator, device) -> SLSTMBlock:
    d, h = cfg.d_model, cfg.n_heads
    dh = head_dim(cfg)
    kw = dict(generator=generator, device=device)
    gates = [M.dense_init(d, d, cfg.dtype, bias=True, **kw) for _ in range(4)]
    # block-diagonal recurrent weights: (H, dh, dh) per gate
    r = (torch.randn((4, h, dh, dh), generator=generator, device=device)
         * dh ** -0.5).to(cfg.dtype)
    return SLSTMBlock(L.norm_init(cfg, device=device), *gates, r,
                      M.dense_init(d, d, cfg.dtype, **kw))


def _write(cache: dict | None, **state) -> None:
    if cache is not None:
        for name, t in state.items():
            cache[name].copy_(t)


def mlstm_block(p: MLSTMBlock, cfg, x: torch.Tensor, cache: dict | None = None,
                backend: str = "auto") -> torch.Tensor:
    """x: (B, S, D). cache: {"c": (B, H, dk, dk), "n": (B, H, dk), "m": (B, H)}."""
    b, s, d = x.shape
    h = cfg.n_heads
    dk = head_dim(cfg)
    inp = L.norm(p.ln, x, cfg)
    q = M.linear(p.wq, inp, backend).reshape(b, s, h, dk).float()
    k = (M.linear(p.wk, inp, backend).reshape(b, s, h, dk) * dk ** -0.5).float()
    v = M.linear(p.wv, inp, backend).reshape(b, s, h, dk).float()
    logi = M.linear(p.wi, inp, backend).float()                   # (B, S, H)
    logf = F.logsigmoid(M.linear(p.wf, inp, backend).float())
    if cache is None:
        c = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, h, dk), dtype=torch.float32, device=x.device)
        m = torch.full((b, h), -1e30, dtype=torch.float32, device=x.device)
    else:
        c, n, m = (cache[name].float() for name in ("c", "n", "m"))
    outs = []
    for t in range(s):
        qi, ki, vi, ii, fi = q[:, t], k[:, t], v[:, t], logi[:, t], logf[:, t]
        m_new = torch.maximum(fi + m, ii)                          # (B, H)
        fg = torch.exp(fi + m - m_new)[..., None]
        ig = torch.exp(ii - m_new)[..., None]
        c = c * fg[..., None] + ig[..., None] * (ki[..., :, None] * vi[..., None, :])
        n = n * fg + ig * ki
        num = torch.einsum("bhkv,bhk->bhv", c, qi)
        den = torch.clamp(torch.einsum("bhk,bhk->bh", n, qi).abs(), min=1.0)
        outs.append(num / den[..., None])
        m = m_new
    out = torch.stack(outs, dim=1).reshape(b, s, d)
    gate = torch.sigmoid(M.linear(p.wo_gate, inp, backend).float())
    y = M.linear(p.wout, (out * gate).to(x.dtype), backend)
    _write(cache, c=c, n=n, m=m)
    return x + y


def slstm_block(p: SLSTMBlock, cfg, x: torch.Tensor, cache: dict | None = None,
                backend: str = "auto") -> torch.Tensor:
    """x: (B, S, D). cache: {"c", "n", "h", "m": (B, D)}."""
    b, s, d = x.shape
    heads = cfg.n_heads
    dh = head_dim(cfg)
    inp = L.norm(p.ln, x, cfg)
    z_in, i_in, f_in, o_in = (M.linear(lin, inp, backend).float()
                              for lin in (p.wz, p.wi, p.wf, p.wo))
    r = p.r.float()                                                # (4, H, dh, dh)
    if cache is None:
        c = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        n = torch.ones((b, d), dtype=torch.float32, device=x.device)
        hv = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        m = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    else:
        c, n, hv, m = (cache[name].float() for name in ("c", "n", "h", "m"))
    outs = []
    for t in range(s):
        # the per-gate recurrent contribution (4, B, D) of the last output
        rz, ri, rf, ro = torch.einsum("bhi,ghio->gbho", hv.reshape(b, heads, dh),
                                      r).reshape(4, b, d)
        z = torch.tanh(z_in[:, t] + rz)
        logf = F.logsigmoid(f_in[:, t] + rf)
        logi = i_in[:, t] + ri
        m_new = torch.maximum(logf + m, logi)
        fg = torch.exp(logf + m - m_new)
        ig = torch.exp(logi - m_new)
        c = fg * c + ig * z
        n = fg * n + ig
        hv = torch.sigmoid(o_in[:, t] + ro) * (c / torch.clamp(n, min=1.0))
        m = m_new
        outs.append(hv)
    y = M.linear(p.wout, torch.stack(outs, dim=1).to(x.dtype), backend)
    _write(cache, c=c, n=n, h=hv, m=m)
    return x + y


def xlstm_plan_specs(kind: str) -> list[PruneSpec]:
    """A block kind's planned projections; none may permute its rows (each
    output feeds the residual stream or a per-channel recurrence)."""
    names = (("wq", "wk", "wv", "wo_gate", "wout") if kind == "mlstm"
             else ("wz", "wi", "wf", "wo", "wout"))
    return [PruneSpec(name, can_permute_rows=False) for name in names]
