"""Error-feedback top-k gradient compression (port of
`repro.optim.compression`).

Each step only the top-k fraction of gradient magnitudes per leaf is sent
(every entry with |g + e| at or above the leaf's k-th largest); the rest
is carried in an f32 error buffer and added back before the next
compression (EF-SGD / EF21).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def ef_topk_init(params):
    return T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def ef_topk_compress(grads, error, k_frac: float = 0.01):
    """Returns (compressed_grads, new_error). Top-k by |g + e| per leaf."""

    def one(g, e):
        g32 = g.float() + e
        flat = g32.reshape(-1)
        k = max(1, int(flat.shape[0] * k_frac))
        thresh = torch.topk(flat.abs(), k).values[-1]
        sent = torch.where(g32.abs() >= thresh, g32, torch.zeros_like(g32))
        return sent.to(g.dtype), g32 - sent

    out = T.map(one, grads, error)
    return (T.map(lambda _, o: o[0], grads, out), T.map(lambda _, o: o[1], grads, out))
