"""Carry weights from the reference package into the port.

`params_from_numpy` takes the reference params tree after
``jax.tree.map(np.asarray, params)``: a nested dict whose ``blocks`` leaves
are layer-stacked ``(L, ...)``, possibly with packed leaves whose fields
are numpy arrays.  Packed leaves are read by duck typing (``vals``,
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
from repro_torch.models import moe as MOE
from repro_torch.models import transformer


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


def params_from_numpy(cfg, tree: dict, device="cuda") -> transformer.Transformer:
    """Build the port's model holding the same numbers as `tree`."""
    device = resolve_device(device)
    blk = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        a = blk["attn"]
        attn = L.Attention(*(_linear(a[n], i, device) for n in ("wq", "wk", "wv", "wo")))
        if "moe" in blk:    # the router and the expert stacks, (L, E, ...) leaves
            ffn = dict(moe=MOE.MoE(**{n: _linear(blk["moe"][n], i, device)
                                      for n in ("router", "wg", "wu", "wd")}))
        else:
            ffn = dict(mlp=L.MLP(**{n: _linear(m, i, device) for n, m in blk["mlp"].items()}))
        blocks.append(transformer.Block(_norm(blk["ln1"], i, device), attn,
                                        _norm(blk["ln2"], i, device), **ffn))
    head = tree["lm_head"]
    return transformer.Transformer(
        M.Embed(to_tensor(tree["embed"]["table"], device)),
        blocks,
        _norm(tree["ln_f"], None, device),
        M.Linear(to_tensor(head["w"], device),
                 None if head.get("b") is None else to_tensor(head["b"], device)),
    )


def masks_from_numpy(cfg, tree: dict, device="cuda") -> list[dict[str, torch.Tensor]]:
    """The reference's `prune_model` masks (after
    ``jax.tree.map(np.asarray, masks)``) as the port's: one {path:
    stored-orientation (n_in, n_out) bool mask} dict per block."""
    device = resolve_device(device)
    blk = tree["blocks"]
    return [{f"{grp}/{name}": to_tensor(node["w"][i], device)
             for grp in ("attn", "mlp", "moe") if grp in blk for name, node in blk[grp].items()
             if node.get("w") is not None}
            for i in range(cfg.n_layers)]
