"""Train / serve step builders (port of `repro.train.steps`).

`make_train_step(cfg, ...)` returns (step_fn, optimizer) where
``step_fn(params, opt_state, masks, batch, step, comp_error=None) ->
(params, opt_state, metrics, comp_error)``.  `params` is the reference's
params tree (`zoo.params_of`): nested dicts whose block leaves are
layer-stacked; `masks` the same tree with a bool leaf where a projection
is masked and ``None`` elsewhere (or ``None`` for no masks).  The
cross-entropy is computed in sequence chunks of `XENT_CHUNK`.

HiNM integration, masked-dense: the forward runs on ``w * m``, a function
of the trainable ``w`` (`zoo.from_params` over the masked tree, so no
weight is copied), so a masked coordinate gets zero gradient; the masks
are re-applied to the updated params.  The step is functional: it
returns new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.models import zoo
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim.compression import ef_topk_compress

XENT_CHUNK = 512


def chunked_xent(model, cfg, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy plus the 1e-4 * logz^2 z-loss, over
    sequence chunks; the padded vocabulary columns take part in logz."""
    b, s, _ = x.shape
    chunk = min(XENT_CHUNK, s)
    if s % chunk:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        logits = zoo.logits_fn(model, cfg, x[:, i:i + chunk]).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, i:i + chunk].long()[..., None])[..., 0]
        # small z-loss for stability at scale
        total = total + ((logz - gold) + 1e-4 * logz ** 2).sum()
    return total / (b * s)


def apply_masks(params, masks):
    """Elementwise multiply where a mask exists (masked-dense training)."""
    if masks is None:
        return params
    return T.map(lambda p, m: p if m is None else p * m.to(p.dtype), params, masks)


def loss_fn(params, cfg, masks, batch) -> torch.Tensor:
    model = zoo.from_params(cfg, apply_masks(params, masks))
    x = zoo.forward(model, cfg, batch["tokens"], embeds=batch.get("embeds"), remat=True)
    return chunked_xent(model, cfg, x, batch["labels"])


def value_and_grad(params, cfg, masks, batch):
    """(loss, grads tree) of `loss_fn` with respect to every params leaf."""
    ws = [p.detach().requires_grad_() for p in T.leaves(params)]
    loss = loss_fn(T.unflatten(params, ws), cfg, masks, batch)
    grads = torch.autograd.grad(loss, ws)
    return loss.detach(), T.unflatten(params, grads)


def accumulate_grads(params, cfg, masks, batch, microbatches: int = 1, acc_dtype=None):
    """(loss, grads) over `batch`: one `value_and_grad`, or with
    `microbatches` > 1 that many row slices of the batch, each gradient
    divided by their count and summed in `acc_dtype` (None: each leaf's
    own dtype), as the reference's scan accumulates them."""
    if microbatches <= 1:
        return value_and_grad(params, cfg, masks, batch)
    g_acc = T.map(lambda p: torch.zeros(p.shape, dtype=acc_dtype or p.dtype, device=p.device),
                  params)
    l_acc = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    for j in range(microbatches):
        mbatch = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))[j] for k, v in batch.items()}
        loss, grads = value_and_grad(params, cfg, masks, mbatch)
        g_acc = T.map(lambda a, g: a + (g / microbatches).to(a.dtype), g_acc, grads)
        l_acc = l_acc + loss / microbatches
    return l_acc, g_acc


def make_train_step(
    cfg,
    optimizer_name: str = "adamw",
    lr_fn=None,
    grad_clip: float = 1.0,
    compress_kfrac: float = 0.0,
    microbatches: int = 1,
):
    """Build the train step.  `microbatches` > 1 accumulates gradients over
    that many slices of the batch, in f32 (in the param dtype for
    Adafactor, the very large configs' optimizer), so the remat'd
    activations shrink by the same factor."""
    opt = make_optimizer(optimizer_name)
    lr_fn = lr_fn or (lambda step: 3e-4)

    # accumulate in f32; Adafactor (the very large configs) in the param
    # dtype, halving the buffer
    acc_dtype = None if optimizer_name == "adafactor" else torch.float32

    def step_fn(params, opt_state, masks, batch, step, comp_error=None):
        loss, grads = accumulate_grads(params, cfg, masks, batch, microbatches, acc_dtype)
        if compress_kfrac > 0.0 and comp_error is not None:
            grads, comp_error = ef_topk_compress(grads, comp_error, compress_kfrac)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(step)
        new_params, new_opt = opt.update(grads, opt_state, params, lr)
        new_params = apply_masks(new_params, masks)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_params, new_opt, metrics, comp_error

    return step_fn, opt


def make_serve_steps(cfg):
    """(prefill_fn, decode_fn) over a model and a decode cache, which they
    update in place and return."""

    def prefill_fn(model, tokens, cache):
        last_x = zoo.prefill(model, cfg, tokens, cache)
        return zoo.logits_fn(model, cfg, last_x), cache

    def decode_fn(model, tokens, cache):
        return zoo.decode_step(model, cfg, tokens, cache), cache

    return prefill_fn, decode_fn
