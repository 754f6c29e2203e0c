"""Abstract views of HiNM-pruned models (port of `repro.train.abstract`),
on the ``meta`` device: shapes and dtypes, nothing allocated.

The gyro permutation is a numeric offline step, but the shapes of masks
and packed weights follow from the config, so the mask and packed trees
are built straight from each model's hinm plan.  `params_shape` is the
counterpart of ``jax.eval_shape(zoo.init)``: the port's init on the meta
device (its draws come from a CPU generator, which a meta tensor takes
without drawing).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.core.types import HiNMConfig, PackedHiNM
from repro_torch.models import zoo
from repro_torch.train import pruning


def params_shape(cfg) -> dict:
    """The params tree (`zoo.params_of`) of `cfg` in meta tensors."""
    return zoo.params_of(cfg, zoo.init(cfg, generator=torch.Generator(), device="meta"))


def _planned(cfg):
    """(stack key, node) of every planned projection, plan order."""
    yield from zoo.perm_graph(cfg).instances()


def packed_leaf_shapes(w_shape: tuple[int, ...], hcfg: HiNMConfig, dtype) -> PackedHiNM:
    """A (…, n_in, n_out) stored weight -> its abstract PackedHiNM (meta
    fields, the leading dims kept)."""
    n_in, n_out = w_shape[-2], w_shape[-1]
    hcfg.validate_shape(n_out, n_in)
    t = n_out // hcfg.v
    k = hcfg.kept_columns(n_in)
    kn = k // hcfg.m * hcfg.n
    lead = tuple(w_shape[:-2])
    meta = dict(device="meta")
    return PackedHiNM(
        vals=torch.empty(lead + (t, hcfg.v, kn), dtype=dtype, **meta),
        vec_idx=torch.empty(lead + (t, k), dtype=torch.int32, **meta),
        nm_idx=torch.empty(lead + (t, hcfg.v, kn), dtype=torch.int8, **meta),
        n_out=n_out, n_in=n_in, config=hcfg)


def abstract_masks(params_shape, cfg):
    """The mask tree: a meta bool leaf at every planned projection's ``w``,
    None everywhere else (`prune_model`'s masks as the training state
    holds them)."""
    masks = T.map(lambda _: None, params_shape)
    for key, node in _planned(cfg):
        w = pruning.get_node(params_shape, key, node.path)["w"]
        pruning.get_node(masks, key, node.path)["w"] = torch.empty(
            tuple(w.shape), dtype=torch.bool, device="meta")
    return masks


def abstract_packed(params_shape, cfg):
    """The params tree with every planned weight an abstract PackedHiNM."""
    packed = T.map(lambda x: x, params_shape)
    for key, node in _planned(cfg):
        n = pruning.get_node(packed, key, node.path)
        n["w"] = packed_leaf_shapes(tuple(n["w"].shape), cfg.hinm, cfg.dtype)
    return packed
