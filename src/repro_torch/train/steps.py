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
from repro_torch.core.types import PackedHiNM
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
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
    reduce_grads=None,
):
    """Build the train step.  `microbatches` > 1 accumulates gradients over
    that many slices of the batch, in f32 (in the param dtype for
    Adafactor, the very large configs' optimizer), so the remat'd
    activations shrink by the same factor.  `reduce_grads(loss, grads) ->
    (loss, grads)`, where given, runs on the accumulated loss and
    gradients before anything else reads them (`shard_train_step`'s
    average over the data-parallel ranks)."""
    opt = make_optimizer(optimizer_name)
    lr_fn = lr_fn or (lambda step: 3e-4)

    # accumulate in f32; Adafactor (the very large configs) in the param
    # dtype, halving the buffer
    acc_dtype = None if optimizer_name == "adafactor" else torch.float32

    def step_fn(params, opt_state, masks, batch, step, comp_error=None):
        loss, grads = accumulate_grads(params, cfg, masks, batch, microbatches, acc_dtype)
        if reduce_grads is not None:
            loss, grads = reduce_grads(loss, grads)
        if compress_kfrac > 0.0 and comp_error is not None:
            grads, comp_error = ef_topk_compress(grads, comp_error, compress_kfrac)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(step)
        new_params, new_opt = opt.update(grads, opt_state, params, lr)
        new_params = apply_masks(new_params, masks)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_params, new_opt, metrics, comp_error

    # what `shard_train_step` builds the step again from, with its hook
    step_fn.kwargs = dict(optimizer_name=optimizer_name, lr_fn=lr_fn, grad_clip=grad_clip,
                          compress_kfrac=compress_kfrac, microbatches=microbatches)
    return step_fn, opt


class ShardedTrainStep:
    """`make_train_step`'s step on a mesh (see `shard_train_step`), called
    as it is, on this rank's shards: ``(params, opt_state, masks, batch,
    step, comp_error=None) -> (params, opt_state, metrics, comp_error)``.

    The storage is sharded and the compute replicated: the shards of the
    params, the optimizer state, the masks (and the error-feedback buffer)
    are all-gathered, the step runs on the whole trees and this rank's rows
    of the batch, built again with a `reduce_grads` that averages the loss
    and the gradients over dp, and each rank keeps its shards of what it
    returns.  A reduce-scatter of the gradients into shard-local updates is
    not here yet."""

    def __init__(self, cfg, mesh, step_kwargs, pspecs, ospecs, mspecs):
        self.cfg, self.mesh = cfg, mesh
        self.pspecs, self.ospecs, self.mspecs = pspecs, ospecs, mspecs
        self._dp = shd.batch_axes(mesh)
        self._ndp = 1
        for a in self._dp:
            self._ndp *= shd.mesh_view(mesh).shape[a]
        self._step, _ = make_train_step(cfg, **step_kwargs, reduce_grads=self.reduce_grads)

    def reduce_grads(self, loss, grads):
        """Each dp rank's loss and gradients are means over its own rows:
        their average over dp is the mean over the global batch."""
        loss = C.all_reduce(loss.clone(), self.mesh, self._dp) / self._ndp
        grads = T.map(lambda g: C.all_reduce(g.contiguous(), self.mesh, self._dp) / self._ndp,
                      grads)
        return loss, grads

    def value_and_grad(self, params, masks, batch):
        """(loss, this rank's shards of the averaged gradients) of one
        batch, without microbatching: the step's first half."""
        full = C.gather_tree(params, self.pspecs, self.mesh)
        fmasks = C.gather_tree(masks, self.mspecs, self.mesh)
        loss, grads = self.reduce_grads(*value_and_grad(full, self.cfg, fmasks, batch))
        return loss, C.place(grads, self.pspecs, self.mesh)

    def __call__(self, params, opt_state, masks, batch, step, comp_error=None):
        def whole(tree, specs):
            return None if tree is None else C.gather_tree(tree, specs, self.mesh)

        new_params, new_opt, metrics, err = self._step(
            whole(params, self.pspecs), whole(opt_state, self.ospecs),
            whole(masks, self.mspecs), batch, step, whole(comp_error, self.pspecs))
        err = None if err is None else C.place(err, self.pspecs, self.mesh)
        return (C.place(new_params, self.pspecs, self.mesh),
                C.place(new_opt, self.ospecs, self.mesh), metrics, err)


def shard_train_step(step_fn, cfg, mesh, params_shape, opt_shape, masks_shape, batch_shape):
    """`step_fn` (from `make_train_step`) on `mesh`: params and optimizer
    state placed by `param_specs` / `opt_state_specs`, masks by the param
    specs, the batch over dp (`batch_specs`), an error-feedback buffer as
    the params.  Returns (step, in_specs, out_specs); `step` is a
    `ShardedTrainStep` over this rank's shards
    (`distributed.collectives.place` cuts them from whole trees).  The
    metrics are `make_train_step`'s."""
    pspecs = shd.param_specs(params_shape, mesh, cfg)
    ospecs = shd.opt_state_specs(opt_shape, pspecs)
    mspecs = T.map(lambda m, s: None if m is None else s, masks_shape, pspecs) \
        if masks_shape is not None else None
    bspecs = shd.batch_specs(batch_shape, mesh)
    in_specs = (pspecs, ospecs, mspecs, bspecs, shd.P(), pspecs)
    out_specs = (pspecs, ospecs, shd.P(), pspecs)
    step = ShardedTrainStep(cfg, mesh, step_fn.kwargs, pspecs, ospecs, mspecs)
    return step, in_specs, out_specs


def make_serve_steps(cfg, mesh=None):
    """(prefill_fn, decode_fn) over a model and a decode cache, which they
    update in place and return.  `mesh` is the reference's argument: the
    steps are the same on one (`shard_serve_step` places them)."""

    def prefill_fn(model, tokens, cache, embeds=None):
        last_x = zoo.prefill(model, cfg, tokens, cache, embeds=embeds)
        return zoo.logits_fn(model, cfg, last_x), cache

    def decode_fn(model, tokens, cache):
        return zoo.decode_step(model, cfg, tokens, cache), cache

    return prefill_fn, decode_fn


def _model_leaves(model):
    """(module, attribute, path) of every tensor and packed weight of a
    model; the path is the reference's params path without the layer
    index ('blocks/attn/wq/w'), which is all its sharding rule reads."""
    for name, mod in model.named_modules():
        segs = [p for p in name.split(".") if p and not p.isdigit()]
        for bname, buf in list(mod._buffers.items()):
            if buf is not None:
                yield mod, bname, "/".join(segs + [bname])
        if isinstance(mod.__dict__.get("w"), PackedHiNM):
            yield mod, "w", "/".join(segs + ["w"])


def _set_leaf(mod, attr: str, value) -> None:
    """A module's tensor or packed weight `attr` set to `value`."""
    if isinstance(value, PackedHiNM):
        mod.w = value
    else:
        mod._buffers[attr] = value


class ShardedServeStep:
    """The decode step on a mesh (see `shard_serve_step`): ``step(tokens)``
    takes the global (B, 1) tokens and returns (logits, cache): the logits
    a `DTensor` over the mesh (batch over dp, vocab over 'model'; its
    ``full_tensor()`` is the whole (B, vocab_padded)), the cache this
    rank's shards, advanced in place.  `ctx.calls` counts the shard-local
    paths the steps took."""

    def __init__(self, decode_fn, cfg, mesh, model, cache, batch: int,
                 seq_parallel: bool = True):
        from repro_torch.kernels.ops import TileShard

        self.decode_fn, self.cfg, self.mesh = decode_fn, cfg, mesh
        self.seq_parallel = seq_parallel
        view = shd.mesh_view(mesh)
        # params by `param_specs`: packed tiles over 'model', the rest by
        # their rules; what is sharded but is not a tile shard is gathered
        # on use
        self._gather = []
        for mod, attr, path in list(_model_leaves(model)):
            leaf = getattr(mod, attr)
            if isinstance(leaf, PackedHiNM):
                specs = [shd.leaf_spec(f"{path}/{f}", getattr(leaf, f).shape, mesh, cfg,
                                       stacked=False) for f in shd.PACKED_FIELDS]
                local = [C.local_shard(getattr(leaf, f), sp, mesh)
                         for f, sp in zip(shd.PACKED_FIELDS, specs)]
                if leaf.vals.dim() == 3 and specs[0][0] == "model" and not any(
                        C.is_sharded(sp[1:]) for sp in specs):
                    mod.w = TileShard(*local, local[0].shape[0] * leaf.config.v, leaf.n_in,
                                      leaf.config, full_n_out=leaf.n_out)
                elif any(C.is_sharded(sp) for sp in specs):
                    mod.w = PackedHiNM(*local, leaf.n_out, leaf.n_in, leaf.config)
                    self._gather.append((mod, attr, specs))
                continue
            spec = shd.leaf_spec(path, leaf.shape, mesh, cfg, stacked=False)
            if C.is_sharded(spec):
                _set_leaf(mod, attr, C.local_shard(leaf, spec, mesh))
                self._gather.append((mod, attr, spec))
        self.model = model
        # the cache by `cache_specs`
        self.cspecs = shd.cache_specs(cache, mesh, cfg)
        roles = zoo.cache_shard_roles(cfg, cache)
        dp = shd.batch_axes(mesh)
        dp = dp if len(dp) > 1 else dp[0]
        self._work = []   # (a local leaf, its spec's axes gathered for a step)
        self.cache = self._place_cache(cache, self.cspecs, roles, dp)
        seq = seq_parallel and any(r == "kv" and len(sp) > 2 and sp[2] == "model"
                                   for r, sp in shd.role_specs(roles, self.cspecs))
        self.ctx = C.MeshContext(mesh, seq_sharded=seq)
        tok_spec = shd.batch_specs({"t": torch.empty((batch, 1), device="meta")}, mesh)["t"]
        self.tok_spec = tok_spec
        self.logits_spec = shd.P(tok_spec[0], "model" if "model" in view.axis_names else None)

    def _place_cache(self, cache, specs, roles, dp):
        if isinstance(cache, dict):
            return {k: self._place_cache(cache[k], specs[k], roles[k], dp) for k in cache}
        if isinstance(cache, (list, tuple)):
            return type(cache)(self._place_cache(c, s, r, dp)
                               for c, s, r in zip(cache, specs, roles))
        if roles == "page" and specs[1] is not None:
            raise ValueError("a page-sharded pool is served by Scheduler(mesh=); "
                             "shard_serve_step takes stripe caches")
        local = C.local_shard(cache, specs, self.mesh)
        # axes other than dp (and a stripe's sequence axis, which the
        # sequence-parallel attention reads where it lies) are gathered
        # for the step and cut again after it
        keep_seq = self.seq_parallel and roles == "kv"
        extra = shd.P(*(ax if ax is not None and ax != dp
                        and not (keep_seq and d == 2) else None
                        for d, ax in enumerate(specs)))
        if C.is_sharded(extra):
            self._work.append((local, extra))
        return local

    def __call__(self, tokens: torch.Tensor, embeds: torch.Tensor | None = None):
        from torch.distributed.tensor import DTensor

        saved = []
        for mod, attr, spec in self._gather:
            local = getattr(mod, attr)
            saved.append((mod, attr, local))
            if isinstance(local, PackedHiNM):
                whole = PackedHiNM(*(C.assemble(getattr(local, f), sp, self.mesh)
                                     for f, sp in zip(shd.PACKED_FIELDS, spec)),
                                   local.n_out, local.n_in, local.config)
            else:
                whole = C.assemble(local, spec, self.mesh)
            _set_leaf(mod, attr, whole)
        work = []
        for local, extra in self._work:
            full = local
            for d, ax in enumerate(extra):
                if ax is not None:
                    full = C.gather_cat(full, self.mesh, ax, dim=d)
            work.append((local, full, extra))
        cache_in = self._swap(self.cache, {id(lo): fu for lo, fu, _ in work})
        rows = shd.P(self.tok_spec[0])
        kw = {} if embeds is None else {"embeds": C.local_shard(embeds, rows, self.mesh)}
        with C.use(self.ctx):
            logits, _ = self.decode_fn(self.model, C.local_shard(tokens, rows, self.mesh),
                                       cache_in, **kw)
        view, where = shd.mesh_view(self.mesh), C.coords(self.mesh)
        for local, full, extra in work:
            local.copy_(full[C.shard_slices(full.shape, extra, view, where)])
        for mod, attr, local in saved:
            _set_leaf(mod, attr, local)
        block = logits
        if self.logits_spec[1] is not None:
            m, n = C.axis_rank(self.mesh, "model")
            v = logits.shape[-1] // n
            block = logits[:, m * v:(m + 1) * v]
        out = DTensor.from_local(block.contiguous(), self.mesh,
                                 shd.to_placements(self.logits_spec, self.mesh),
                                 run_check=False)
        return out, self.cache

    def _swap(self, tree, by_id):
        if isinstance(tree, dict):
            return {k: self._swap(v, by_id) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._swap(v, by_id) for v in tree)
        return by_id.get(id(tree), tree)


def shard_serve_step(decode_fn, cfg, mesh, params, cache, batch: int):
    """The decode step on `mesh` (a `DeviceMesh`): `params` — a model, its
    planned projections packed — placed by `param_specs` (each packed
    weight's tiles over 'model': every projection runs the T-sharded K1
    over the rank's own tiles, `ops.hinm_spmm_shard_map`), the stripe
    `cache` by `cache_specs` (batch over dp, the sequence over 'model':
    decode attention is sequence-parallel,
    `layers._seq_parallel_decode_attn`).  Both are placed in place: the
    model and cache given become this rank's.  Returns (step, pspecs,
    cspecs); `step` is a `ShardedServeStep`."""
    from repro_torch.train import abstract

    tree = abstract.params_shape(cfg)
    if any(isinstance(getattr(m, "w", None), PackedHiNM) for m in params.modules()):
        tree = abstract.abstract_packed(tree, cfg)
    pspecs = shd.param_specs(tree, mesh, cfg)
    step = ShardedServeStep(decode_fn, cfg, mesh, params, cache, batch)
    return step, pspecs, step.cspecs
