"""Token sampling for the serving runtime (port of `repro.serve.sampler`).

Sampling parameters are per-slot vectors, so one fixed-width decode batch
mixes greedy and stochastic requests.  Temperature sampling feeds the
scaled (and top-k / top-p masked) logits to `prng.categorical`, the port's
bit-exact copy of `jax.random.categorical`.

RNG discipline, as the reference's: every draw uses a per-slot,
per-position key, ``fold_in(fold_in(base, request_seed), token_index)``
(`fold_keys`), so a request's sampled stream depends only on its seed and
how many tokens it has generated, never on its slot or co-residents.
That is what lets speculative decoding recompute the exact token the
non-speculative loop would have drawn at each position (serve/spec).
"""
from __future__ import annotations

import torch

from repro_torch.serve import prng


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, V) -> argmax token ids (B,) int32 (first maximum on ties,
    as `jnp.argmax`)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def fold_keys(base_key: torch.Tensor, seeds: torch.Tensor, gens: torch.Tensor) -> torch.Tensor:
    """Per-slot draw keys (B, 2): `base_key` folded by request seed, then by
    the token index the slot is about to sample.  seeds/gens (B,) integer."""
    return prng.fold_in(prng.fold_in(base_key, seeds), gens)


def mask_logits(logits: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-slot top-k then top-p (nucleus) masking.  logits (B, V) f32
    (already temperature-scaled); top_k (B,) int (<= 0 -> full vocab);
    top_p (B,) f32 (<= 0 or >= 1 -> disabled).  Nucleus keeps the smallest
    prefix of the descending distribution whose mass reaches top_p (the
    first token always survives); ties at the cutoff probability are kept."""
    v = logits.shape[-1]
    k = torch.clamp(top_k.to(torch.int64), 0, v)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, torch.clamp(k - 1, min=0)[:, None])
    masked = logits.masked_fill((k[:, None] > 0) & (logits < kth), float("-inf"))

    # nucleus on the top-k survivors: -inf rows softmax to exactly 0
    probs = torch.softmax(masked, dim=-1)
    p_desc = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(p_desc, dim=-1)
    keep = (cum - p_desc) < top_p[:, None]          # exclusive prefix mass
    cutoff = p_desc.masked_fill(~keep, float("inf")).amin(dim=-1)
    on = (top_p > 0.0) & (top_p < 1.0)
    return masked.masked_fill(on[:, None] & (probs < cutoff[:, None]), float("-inf"))


def sample(keys: torch.Tensor, logits: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor, top_p: torch.Tensor | None = None) -> torch.Tensor:
    """Per-slot sampling.  keys (B, 2) per-slot keys (see `fold_keys`);
    logits (B, V) float32; temperature (B,) float32 (<= 0 -> greedy); top_k
    (B,) int (<= 0 -> full vocab); top_p (B,) float32 (<= 0 -> disabled).
    Returns token ids (B,) int32."""
    pick = greedy(logits)
    if top_p is None:
        top_p = torch.zeros(logits.shape[:1], dtype=torch.float32, device=logits.device)
    t = torch.clamp(temperature, min=1e-6)[:, None]
    masked = mask_logits(logits / t, top_k, top_p)
    drawn = prng.categorical(keys, masked).to(torch.int32)
    return torch.where(temperature > 0.0, drawn, pick)
