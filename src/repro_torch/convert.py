"""Carry weights from the reference package into the port.

`params_from_numpy` takes the reference params tree after
``jax.tree.map(np.asarray, params)``: a nested dict whose ``blocks`` leaves
(an encoder-decoder's ``enc`` and ``dec`` leaves; a recurrent family's
``stacks[j]``, one tree a pattern position) are layer-stacked
``(L, ...)``, possibly with packed leaves whose fields are numpy arrays.  Packed leaves are read by duck typing (``vals``,
``vec_idx``, ``nm_idx``, ``n_out``, ``n_in``, ``config.{v,n,m,
vector_sparsity}``), so the port never imports the reference.  The
reference's `prune_model` outputs cross the same way: its permuted params
and packed tree through `params_from_numpy`, its masks through
`masks_from_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import HiNMConfig, PackedHiNM
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import encdec
from repro_torch.models import moe as MOE
from repro_torch.models import transformer, xlstm_model


def to_tensor(a, device) -> torch.Tensor:
    """numpy -> torch, bit for bit (bfloat16 arrives as ml_dtypes'
    bfloat16, which `torch.from_numpy` does not take: reinterpret bits)."""
    a = np.array(a, copy=True, order="C")  # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _is_packed(leaf) -> bool:
    return hasattr(leaf, "vals") and hasattr(leaf, "vec_idx")


def _linear(node: dict, i: int, device) -> M.Linear:
    w = node["w"]
    if _is_packed(w):
        c = w.config
        w = PackedHiNM(
            vals=to_tensor(w.vals[i], device),
            vec_idx=to_tensor(np.asarray(w.vec_idx[i], np.int32), device),
            nm_idx=to_tensor(np.asarray(w.nm_idx[i], np.int8), device),
            n_out=int(w.n_out), n_in=int(w.n_in),
            config=HiNMConfig(v=c.v, n=c.n, m=c.m, vector_sparsity=c.vector_sparsity))
    else:
        w = to_tensor(w[i], device)            # (n_in, n_out), as stored
    b = node.get("b")
    return M.Linear(w, None if b is None else to_tensor(b[i], device))


def _norm(node: dict, i, device) -> M.Norm:
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    bias = node.get("bias")
    return M.Norm(to_tensor(pick(node["scale"]), device),
                  None if bias is None else to_tensor(pick(bias), device))


def _attention(node: dict, i: int, device) -> L.Attention:
    return L.Attention(*(_linear(node[n], i, device) for n in ("wq", "wk", "wv", "wo")))


def _mlp(node: dict, i: int, device) -> L.MLP:
    return L.MLP(**{n: _linear(m, i, device) for n, m in node.items()})


def _head(node: dict, device) -> M.Linear:
    return M.Linear(to_tensor(node["w"], device),
                    None if node.get("b") is None else to_tensor(node["b"], device))


def _encdec_from_numpy(cfg, tree: dict, device) -> encdec.EncDec:
    enc, dec = tree["enc"], tree["dec"]
    return encdec.EncDec(
        _head(tree["frontend_proj"], device),
        M.Embed(to_tensor(tree["embed"]["table"], device)),
        [encdec.EncLayer(_norm(enc["ln1"], i, device), _attention(enc["attn"], i, device),
                         _norm(enc["ln2"], i, device), _mlp(enc["mlp"], i, device))
         for i in range(encdec.n_enc_layers(cfg))],
        [encdec.DecLayer(_norm(dec["ln1"], i, device), _attention(dec["attn"], i, device),
                         _norm(dec["ln_x"], i, device), _attention(dec["xattn"], i, device),
                         _norm(dec["ln2"], i, device), _mlp(dec["mlp"], i, device))
         for i in range(cfg.n_layers)],
        _norm(tree["ln_enc"], None, device), _norm(tree["ln_f"], None, device),
        _head(tree["lm_head"], device))


def _xlstm_from_numpy(cfg, tree: dict, device) -> xlstm_model.XLSTM:
    stacks = [[xlstm_model.block_from(kind, node, i,
                                      lin=lambda n, i: _linear(n, i, device),
                                      norm=lambda n, i: _norm(n, i, device),
                                      leaf=lambda a, i: to_tensor(a[i], device))
               for i in range(xlstm_model.n_periods(cfg))]
              for kind, node in zip(xlstm_model.pattern(cfg), tree["stacks"])]
    return xlstm_model.XLSTM(M.Embed(to_tensor(tree["embed"]["table"], device)), stacks,
                             _norm(tree["ln_f"], None, device), _head(tree["lm_head"], device))


def params_from_numpy(cfg, tree: dict, device="cuda"):
    """Build the port's model holding the same numbers as `tree`."""
    device = resolve_device(device)
    if cfg.family == "encdec":
        return _encdec_from_numpy(cfg, tree, device)
    if cfg.family == "ssm":
        return _xlstm_from_numpy(cfg, tree, device)
    blk = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        attn = _attention(blk["attn"], i, device)
        if "moe" in blk:    # the router and the expert stacks, (L, E, ...) leaves
            ffn = dict(moe=MOE.MoE(**{n: _linear(blk["moe"][n], i, device)
                                      for n in ("router", "wg", "wu", "wd")}))
        else:
            ffn = dict(mlp=_mlp(blk["mlp"], i, device))
        blocks.append(transformer.Block(_norm(blk["ln1"], i, device), attn,
                                        _norm(blk["ln2"], i, device), **ffn))
    return transformer.Transformer(
        M.Embed(to_tensor(tree["embed"]["table"], device)),
        blocks,
        _norm(tree["ln_f"], None, device),
        _head(tree["lm_head"], device),
    )


def _stack_masks(blk: dict, n: int, device) -> list[dict[str, torch.Tensor]]:
    return [{f"{grp}/{name}": to_tensor(node["w"][i], device)
             for grp in ("attn", "xattn", "mlp", "moe") if grp in blk
             for name, node in blk[grp].items() if node.get("w") is not None}
            for i in range(n)]


def masks_from_numpy(cfg, tree: dict, device="cuda"):
    """The reference's `prune_model` masks (after
    ``jax.tree.map(np.asarray, masks)``) as the port's: one {path:
    stored-orientation (n_in, n_out) bool mask} dict per block; for an
    encoder-decoder, ``{"enc": [...], "dec": [...]}`` of such lists, for a
    recurrent family ``{"stack0": [...], "stack1": [...]}`` (the
    reference's ``stacks[j]``)."""
    device = resolve_device(device)
    if cfg.family == "ssm":
        return {f"stack{j}": [{name: to_tensor(node["w"][i], device)
                               for name, node in stack.items()
                               if isinstance(node, dict) and node.get("w") is not None}
                              for i in range(xlstm_model.n_periods(cfg))]
                for j, stack in enumerate(tree["stacks"])}
    if cfg.family == "encdec":
        return {"enc": _stack_masks(tree["enc"], encdec.n_enc_layers(cfg), device),
                "dec": _stack_masks(tree["dec"], cfg.n_layers, device)}
    return _stack_masks(tree["blocks"], cfg.n_layers, device)
