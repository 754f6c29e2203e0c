"""Launch cells (port of `repro.launch.cells`): (arch config, input shape,
mesh) -> a step.

A cell is one (architecture x input shape) point of the assignment
matrix.  Kinds:
  train    -> the masked-dense HiNM train step (params + optimizer state +
              masks), `steps.shard_train_step`
  prefill  -> the serving prefill over packed HiNM weights (fills the cache)
  decode   -> the serving decode step over packed HiNM weights (one token),
              `steps.shard_serve_step`

A cell holds its step, its arguments as meta tensors (shapes and dtypes,
nothing allocated) and its input specs; on an `AbstractMesh` (the
production meshes) that is all it is.  `run_cell` runs one on a real
`DeviceMesh`, with seeded random weights and inputs, at the shape the
cell was built for (pass `shape_override` to `build_cell` to cut it).
The reference's `lower_cell` lowers to XLA HLO and has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.distributed import sharding as shd
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer
from repro_torch.train import abstract as abst
from repro_torch.train import steps as tsteps


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step: Any            # train: a ShardedTrainStep; serve: None until run_cell
    args: tuple          # meta tensors
    specs: tuple = ()
    skipped: str = ""
    seq: int = 0
    batch: int = 0


def shape_applicable(cfg: ArchConfig, shape_name: str) -> str:
    """'' if the cell runs; otherwise the documented skip reason."""
    if shape_name in cfg.skip_shapes:
        return "excluded by config"
    if shape_name == "long_500k" and not cfg.sub_quadratic():
        return "full quadratic attention at 524k seq is out of scope (DESIGN.md §6)"
    return ""


def pick_microbatches(cfg: ArchConfig, seq: int, batch: int, mesh,
                      budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation factor keeping the remat'd layer-input stack
    (L x B_local x S x D x 2 bytes) under ~4 GB a device; it divides the
    per-device batch, so every microbatch still shards evenly."""
    view = shd.mesh_view(mesh)
    dp = 1
    for a in shd.batch_axes(mesh):
        dp *= view.shape[a]
    b_loc = max(1, batch // dp)
    stack = cfg.n_layers * b_loc * seq * cfg.d_model * 2
    m = 1
    while stack / m > budget_bytes and m < b_loc and b_loc % (m * 2) == 0:
        m *= 2
    return m


def _shape(shape_name, shape_override):
    seq, batch, _ = SHAPES[shape_name]
    return shape_override if shape_override else (seq, batch)


def build_train_cell(cfg: ArchConfig, shape_name: str, mesh,
                     shape_override: tuple[int, int] | None = None) -> Cell:
    seq, batch = _shape(shape_name, shape_override)
    params_shape = abst.params_shape(cfg)
    opt_shape = make_optimizer(cfg.optimizer).init(params_shape)
    masks_shape = abst.abstract_masks(params_shape, cfg)
    batch_shape = make_batch_specs(seq, batch, cfg.vocab, cfg.frontend, cfg.d_model,
                                   cfg.frontend_tokens)
    mb = pick_microbatches(cfg, seq, batch, mesh)
    step_fn, _ = tsteps.make_train_step(cfg, optimizer_name=cfg.optimizer, microbatches=mb)
    step, in_specs, _ = tsteps.shard_train_step(step_fn, cfg, mesh, params_shape, opt_shape,
                                                masks_shape, batch_shape)
    args = (params_shape, opt_shape, masks_shape, batch_shape,
            torch.empty((), dtype=torch.int32, device="meta"), None)
    return Cell(cfg.name, shape_name, "train", step, args, in_specs, seq=seq, batch=batch)


def _serve_shapes(cfg: ArchConfig, seq: int, batch: int):
    packed_shape = abst.abstract_packed(abst.params_shape(cfg), cfg)
    kw = {}
    cache_seq = seq
    if cfg.family == "encdec":
        kw["t_enc"] = seq
        cache_seq = max(seq // 4, 8)
    cache_shape = zoo.make_cache(cfg, batch, cache_seq, device="meta", **kw)
    return packed_shape, cache_shape


def build_decode_cell(cfg: ArchConfig, shape_name: str, mesh,
                      shape_override: tuple[int, int] | None = None) -> Cell:
    seq, batch = _shape(shape_name, shape_override)
    packed_shape, cache_shape = _serve_shapes(cfg, seq, batch)
    tokens = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    specs = (shd.param_specs(packed_shape, mesh, cfg),
             shd.batch_specs({"t": tokens}, mesh)["t"], shd.cache_specs(cache_shape, mesh, cfg))
    return Cell(cfg.name, shape_name, "decode", None, (packed_shape, tokens, cache_shape),
                specs, seq=seq, batch=batch)


def _prefill_inputs(cfg, seq, batch, device="meta", generator=None):
    """(tokens, embeds or None) of a prefill cell: an encoder-decoder's
    S frames and S // 4 tokens, a vlm's P patch rows and S - P tokens."""
    def tok(n):
        if device == "meta":
            return torch.empty((batch, n), dtype=torch.int32, device="meta")
        return torch.randint(0, cfg.vocab, (batch, n), generator=generator).to(device)

    def emb(n):
        if device == "meta":
            return torch.empty((batch, n, cfg.d_model), dtype=torch.bfloat16, device="meta")
        return torch.randn((batch, n, cfg.d_model), generator=generator).to(device)

    if cfg.family == "encdec":
        return tok(seq // 4), emb(seq)
    if cfg.frontend == "patch":
        return tok(seq - cfg.frontend_tokens), emb(cfg.frontend_tokens)
    return tok(seq), None


def build_prefill_cell(cfg: ArchConfig, shape_name: str, mesh,
                       shape_override: tuple[int, int] | None = None) -> Cell:
    seq, batch = _shape(shape_name, shape_override)
    packed_shape, cache_shape = _serve_shapes(cfg, seq, batch)
    tokens, embeds = _prefill_inputs(cfg, seq, batch)
    args = (packed_shape, tokens, cache_shape) + (() if embeds is None else (embeds,))
    specs = (shd.param_specs(packed_shape, mesh, cfg),
             shd.batch_specs({"t": tokens}, mesh)["t"], shd.cache_specs(cache_shape, mesh, cfg))
    return Cell(cfg.name, shape_name, "prefill", None, args, specs, seq=seq, batch=batch)


def build_cell(cfg: ArchConfig, shape_name: str, mesh,
               shape_override: tuple[int, int] | None = None) -> Cell:
    skip = shape_applicable(cfg, shape_name)
    if skip:
        return Cell(cfg.name, shape_name, SHAPES[shape_name][2], None, (), skipped=skip)
    kind = SHAPES[shape_name][2]
    if kind == "train":
        return build_train_cell(cfg, shape_name, mesh, shape_override)
    if kind == "prefill":
        return build_prefill_cell(cfg, shape_name, mesh, shape_override)
    return build_decode_cell(cfg, shape_name, mesh, shape_override)


def run_cell(cell: Cell, cfg: ArchConfig, mesh, device="cpu", seed: int = 0):
    """Run `cell` once on the `DeviceMesh` `mesh`, with weights and inputs
    drawn from `seed` (the same on every rank).  Returns the train step's
    metrics, or the serve step's logits (a DTensor over the mesh)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.train import gradual

    if cell.skipped:
        raise ValueError(f"cell {cell.arch} x {cell.shape} is skipped: {cell.skipped}")
    gen = torch.Generator().manual_seed(seed)
    model = zoo.init(cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    if cell.kind == "train":
        params = zoo.params_of(cfg, model)
        opt_state = make_optimizer(cfg.optimizer).init(params)
        masks = gradual.recompute_masks(params, cfg, cfg.hinm, nm_on=True)
        b = cell.args[3]
        batch = {k: (torch.randint(0, cfg.vocab, tuple(v.shape), generator=gen)
                     if k != "embeds" else torch.randn(tuple(v.shape), generator=gen)).to(device)
                 for k, v in b.items()}
        pspecs, ospecs, mspecs, bspecs = cell.specs[:4]
        _, _, metrics, _ = cell.step(C.place(params, pspecs, mesh),
                                     C.place(opt_state, ospecs, mesh),
                                     C.place(masks, mspecs, mesh),
                                     C.place(batch, bspecs, mesh), 0)
        return metrics
    model = zoo.pack_params(cfg, model)
    kw = {"t_enc": cell.seq} if cfg.family == "encdec" else {}
    cache_seq = max(cell.seq // 4, 8) if cfg.family == "encdec" else cell.seq
    cache = zoo.make_cache(cfg, cell.batch, cache_seq, device=device, **kw)
    prefill_fn, decode_fn = tsteps.make_serve_steps(cfg, mesh)
    if cell.kind == "prefill":
        tokens, embeds = _prefill_inputs(cfg, cell.seq, cell.batch, device, gen)
        step = tsteps.ShardedServeStep(prefill_fn, cfg, mesh, model, cache, cell.batch,
                                       seq_parallel=False)
        cell.step = step
        return step(tokens, embeds)[0]
    step, _, _ = tsteps.shard_serve_step(decode_fn, cfg, mesh, model, cache, cell.batch)
    cell.step = step
    tokens = torch.randint(0, cfg.vocab, (cell.batch, 1), generator=gen).to(device)
    return step(tokens)[0]
