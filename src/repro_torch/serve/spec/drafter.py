"""Draft-token proposal for speculative decoding (port of
`repro.serve.spec.drafter`).

``NgramDrafter`` is host-free self-speculative prompt lookup: the
scheduler keeps a device-resident per-slot token history (prompt +
emitted tokens); `ngram_propose` finds the most recent earlier occurrence
of the trailing n-gram in it and proposes the tokens that followed.  No
extra model and no extra weight reads; acceptance is high exactly when
the output re-walks its own context.

``ModelDrafter`` is a paired small model (qwen2_0_5b drafting for
qwen2_5_14b, declared as ``ArchConfig.draft_arch`` and resolved by
`from_zoo`).  The scheduler runs it for ``k + 1`` greedy decode steps a
cycle in its own stripe `SlotKVCache`; the extra step writes the last
draft's own cache row, so the draft pool tracks the target pool row for
row and the same accept count rolls both back.  It costs the draft
model's weight reads and prefill, and wins where the draft predicts the
target (a trained pair); the n-gram drafter costs neither.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def seed_history(prompt, first_token: int, max_seq: int):
    """(history row, length) arming a slot's n-gram corpus at admission:
    the request's complete prompt followed by its first sampled token."""
    row = np.zeros((max_seq,), np.int32)
    plen = min(len(prompt), max_seq - 1)
    row[:plen] = prompt[:plen]
    row[plen] = first_token
    return row, plen + 1


def ngram_propose(hist: torch.Tensor, hlen: torch.Tensor, tok: torch.Tensor,
                  k: int, n: int = 2) -> torch.Tensor:
    """Prompt-lookup proposals (B, k) int32.  hist (B, H) token history
    (prompt + emitted, the pending token last); hlen (B,) valid rows; tok
    (B, 1) the pending token.  Finds the latest j < hlen - n with
    ``hist[j:j+n] == hist[hlen-n:hlen]`` and proposes ``hist[j+n : j+n+k]``;
    positions with no match (or past the history) repeat the pending
    token, a cheap guess the verify step simply rejects."""
    b, h = hist.shape
    dev = hist.device
    hlen = hlen.to(torch.int64)
    # trailing n-gram per slot (clamped reads are masked by the hlen check)
    gram = torch.stack([
        torch.gather(hist, 1, torch.clamp(hlen - n + i, 0, h - 1)[:, None])[:, 0]
        for i in range(n)], dim=1)                           # (B, n)
    ok = torch.ones((b, h - n + 1), dtype=torch.bool, device=dev)
    for i in range(n):
        ok &= hist[:, i: h - n + 1 + i] == gram[:, i][:, None]
    j_ar = torch.arange(h - n + 1, dtype=torch.int64, device=dev)
    cand = torch.where(ok & (j_ar[None, :] < (hlen - n)[:, None]), j_ar[None, :], -1)
    jbest = cand.amax(dim=1)                                 # (B,) -1 = none
    idx = (jbest + n)[:, None] + torch.arange(k, dtype=torch.int64, device=dev)[None, :]
    guess = torch.gather(hist, 1, torch.clamp(idx, 0, h - 1))
    usable = (jbest[:, None] >= 0) & (idx < hlen[:, None])
    return torch.where(usable, guess, tok.to(hist.dtype)).to(torch.int32)


def append_history(hist: torch.Tensor, hlen: torch.Tensor, emits: torch.Tensor,
                   cnt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Append each slot's ``cnt`` emitted tokens (``emits (B, S)``, -1 pad)
    to its history; returns (hist', hlen').  Writes past the buffer are
    dropped (it is sized for prompt + max_new, so only pads reach there)."""
    b, s = emits.shape
    h = hist.shape[1]
    dev = hist.device
    ar = torch.arange(s, dtype=torch.int64, device=dev)
    idx = hlen.to(torch.int64)[:, None] + ar[None, :]
    live = (ar[None, :] < cnt[:, None]) & (idx < h)
    # rows that are not live land in one spare column, cut off after
    out = torch.cat([hist, torch.zeros((b, 1), dtype=hist.dtype, device=dev)], dim=1)
    out[torch.arange(b, device=dev)[:, None], torch.where(live, idx, h)] = emits.to(hist.dtype)
    out = out[:, :h]
    return out, hlen + cnt.to(hlen.dtype)


class Drafter:
    """Interface: `kind` tags how the scheduler wires proposals."""

    kind = ""


class NgramDrafter(Drafter):
    """Self-speculative prompt-lookup drafter (no draft model)."""

    kind = "ngram"

    def __init__(self, n: int = 2):
        if n < 1:
            raise ValueError("n-gram order must be >= 1")
        self.n = n


class ModelDrafter(Drafter):
    """Paired small draft model with its own stripe KV pool.  ``params`` is
    the draft model (the port's model object, as `Scheduler` takes)."""

    kind = "model"

    def __init__(self, cfg, params):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"draft model family {cfg.family!r} is not supported: the drafter "
                "decodes plain token prompts (no embeds frontend)")
        self.cfg = cfg
        self.params = params

    @classmethod
    def from_zoo(cls, target_cfg, rng_seed: int = 0, reduced: dict | None = None,
                 device="cuda"):
        """Resolve ``target_cfg.draft_arch`` through the port's configs and
        init the draft's weights from a seeded generator on `device`.
        ``reduced`` overrides shrink the draft to match a `.reduced()`
        target; the vocabularies must line up (drafts are ids the target
        scores).  The weights are random: pass checkpointed ones to the
        constructor for a real deployment."""
        from repro_torch.configs.base import load_arch
        from repro_torch.models import zoo

        arch = getattr(target_cfg, "draft_arch", "")
        if not arch:
            raise ValueError(f"{target_cfg.name}: no draft_arch pairing declared")
        cfg = load_arch(arch)
        if reduced is not None:
            cfg = cfg.reduced(**reduced)
        if cfg.vocab > target_cfg.vocab:
            raise ValueError(
                f"draft vocab {cfg.vocab} exceeds target vocab {target_cfg.vocab}: "
                "drafts would be unscorable ids")
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(rng_seed)
        return cls(cfg, zoo.init(cfg, gen, device))
