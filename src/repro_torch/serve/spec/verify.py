"""Acceptance logic for the multi-token verify step (port of
`repro.serve.spec.verify`).

One verify forward scores ``S = k + 1`` input tokens per slot, the pending
token followed by k drafts; ``logits[:, i]`` is the target's distribution
for the token after input i.  `acceptance` decides per slot:

* greedy slots: accept the leading run of drafts that match the argmax
  chain, then emit the argmax at the first mismatch (the correction) or
  after a full run (the bonus) — exactly the non-speculative greedy stream;
* stochastic slots, "match" (default): the same, against the token
  `sampler.sample` draws with the slot's per-position key — exactly the
  token the non-speculative loop would have drawn at that stream index;
* stochastic slots, "reject": rejection sampling against the greedy
  drafter's delta proposal (accept draft d_i with probability p_i(d_i);
  on the first rejection draw from p_i with d_i removed; after a full run
  draw the bonus from p_K).  Unbiased, a different stream.

Emission is capped by the slot's remaining budget and cut at the first
EOS; the count doubles as the cache-row ``keep`` of the rollback that
follows every verify.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.serve import prng, sampler


def position_keys(base_key: torch.Tensor, seeds: torch.Tensor, gens: torch.Tensor,
                  s: int) -> torch.Tensor:
    """(B, S, 2) draw keys: key[b, i] is exactly the key the
    non-speculative loop uses for slot b's token index gens[b] + i."""
    kb = prng.fold_in(base_key, seeds)                              # (B, 2)
    idx = gens.to(torch.int64)[:, None] + torch.arange(s, device=gens.device)[None, :]
    return prng.fold_in(kb[:, None, :], idx)


def acceptance(logits, drafts, tok, *, base_key, seeds, gens, temp, topk, topp, eos,
               rem, active, k_eff, match, stochastic: bool, any_reject: bool = True):
    """Vectorized accept/emit for one verify step.

    logits (B, S, V) f32; drafts (B, S-1) int32; tok (B, 1) pending token.
    Per-slot vectors: temp/topp f32, topk/eos/rem/gens/seeds/k_eff int,
    active/match bool.  `stochastic` (some lane samples) and `any_reject`
    (some sampled lane uses "reject") elide the work no lane needs.
    Returns (emits (B, S) int32 with -1 padding, cnt (B,) emitted == cache
    rows kept, judged (B,) drafts whose verdict reached the stream, tok',
    active', rem', gens')."""
    b, s, v = logits.shape
    k = s - 1
    dev = logits.device
    ar = torch.arange(s, device=dev)

    g_tok = torch.argmax(logits, dim=-1).to(torch.int32)            # (B, S)
    use_reject = stochastic and any_reject
    if stochastic:
        keys = position_keys(base_key, seeds, gens, s)              # (B, S, 2)
        keys_flat = keys.reshape(b * s, 2)
        lg_flat = logits.reshape(b * s, v)

        def flat(a):   # (B,) -> (B * S,), each slot's value S times
            return a[:, None].expand(b, s).reshape(b * s)

        samp = sampler.sample(keys_flat, lg_flat, flat(temp), flat(topk),
                              flat(topp)).reshape(b, s)
        tgt = torch.where((temp > 0)[:, None], samp, g_tok)
    else:
        tgt = g_tok
    if use_reject:
        t = torch.clamp(temp, min=1e-6)
        masked = sampler.mask_logits(lg_flat / flat(t)[:, None], flat(topk),
                                     flat(topp)).reshape(b, s, v)
        probs = torch.softmax(masked, dim=-1)
        d64 = drafts.to(torch.int64)
        p_draft = torch.gather(probs[:, :k], 2, d64[..., None])[..., 0]   # (B, k)
        u = prng.uniform(prng.fold_in(keys_flat, 1)).reshape(b, s)[:, :k]
        rs_accept = u < p_draft
        # residual draw: p with the rejected draft removed
        res_logits = masked[:, :k].masked_fill(F.one_hot(d64, v).bool(), float("-inf"))
        res = prng.categorical(prng.fold_in(keys[:, :k].reshape(b * k, 2), 2),
                               res_logits.reshape(b * k, v)).to(torch.int32).reshape(b, k)
    else:
        rs_accept = torch.zeros((b, k), dtype=torch.bool, device=dev)
        res = torch.zeros((b, k), dtype=torch.int32, device=dev)

    use_match = match | (temp <= 0)
    hit = torch.where(use_match[:, None], drafts == tgt[:, :k], rs_accept)
    hit &= ar[None, :k] < k_eff[:, None]       # per-request draft-length cap
    n_acc = torch.cumprod(hit.to(torch.int32), dim=1).sum(dim=1)   # (B,)

    # token emitted at position i: accepted draft (i < n), else the
    # correction/bonus (i == n): the target token in match mode; the
    # residual draw (mismatch) or plain sample (full run) in reject mode
    corr = tgt
    if use_reject:
        corr_rej = torch.cat([res, tgt[:, k:]], dim=1)
        corr = torch.where(use_match[:, None], tgt, corr_rej)
    pad_drafts = torch.cat([drafts, torch.zeros((b, 1), dtype=drafts.dtype, device=dev)],
                           dim=1)
    minus1 = torch.full_like(corr, -1)
    emits0 = torch.where(ar[None, :] < n_acc[:, None], pad_drafts,
                         torch.where(ar[None, :] == n_acc[:, None], corr, minus1))

    cnt = torch.minimum(n_acc + 1, rem)
    is_eos = ((eos[:, None] >= 0) & (emits0 == eos[:, None])
              & (ar[None, :] < cnt[:, None]))
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
    any_eos = is_eos.any(dim=1)
    cnt = torch.where(any_eos, torch.minimum(cnt, first_eos + 1), cnt)
    # inactive lanes emit and keep nothing: cnt is the rollback's keep, so
    # zero rewinds their verify rows, and append_history adds them nothing
    cnt = torch.where(active, cnt, torch.zeros_like(cnt))

    emits = torch.where(ar[None, :] < cnt[:, None], emits0, minus1)
    last = torch.gather(emits0, 1, torch.clamp(cnt - 1, min=0)[:, None].to(torch.int64))[:, 0]
    hit_eos = any_eos & active
    rem2 = rem - cnt
    active2 = active & ~hit_eos & (rem2 > 0)
    tok2 = torch.where(active2, last, tok[:, 0])[:, None]
    gens2 = gens + cnt
    # drafts judged for the acceptance rate: the cnt-1 accepted ones that
    # reached the stream, plus the one whose rejection did (its correction
    # was emitted); drafts past an EOS or budget cut are not counted
    judged = torch.clamp(cnt - 1, min=0) + ((cnt == n_acc + 1) & (n_acc < k_eff)).to(cnt.dtype)
    judged = torch.where(cnt > 0, judged, torch.zeros_like(judged))
    return (emits.to(torch.int32), cnt, judged, tok2.to(tok.dtype), active2, rem2.to(rem.dtype),
            gens2.to(gens.dtype))
