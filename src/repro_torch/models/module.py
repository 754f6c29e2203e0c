"""Building blocks of the port's models (port of `repro.models.module`).

The reference keeps params as nested dicts of arrays; the port keeps them
in `nn.Module`s with the same attribute names (``embed.table``,
``blocks[i].attn.wq.w``, ...), so `get_path`/`set_path` address the same
paths.  Linear weights are stored (n_in, n_out) — ``x @ w`` — exactly as
the reference stores them; the HiNM format is defined on (n_out, n_in),
so packing operates on ``w.T``, and `linear` dispatches between a dense
and a packed weight.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.types import PackedHiNM
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class PruneSpec:
    """One prunable projection and its permutation coupling (see
    `repro.models.module.PruneSpec`): `perm.graph.compile_layer_graph`
    reads every field — `row_blocks` and `can_permute_rows` bound its OCP
    search, `consumers` and `tied` become the edges its permutation is
    folded along."""

    path: str
    row_blocks: int = 1
    can_permute_rows: bool = True
    consumers: tuple[str, ...] = ()
    tied: tuple[str, ...] = ()


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` either a dense (n_in, n_out) buffer or a
    `PackedHiNM` (then the projection runs through ``ops.hinm_matmul``)."""

    def __init__(self, w: torch.Tensor | PackedHiNM, b: torch.Tensor | None = None):
        super().__init__()
        self.set_weight(w)
        self.register_buffer("b", b)

    def set_weight(self, w: torch.Tensor | PackedHiNM) -> None:
        """Swap the weight between its dense and packed forms in place."""
        self._buffers.pop("w", None)
        self.__dict__.pop("w", None)
        if isinstance(w, PackedHiNM):
            self.w = w
        else:
            self.register_buffer("w", w)


def linear(p: Linear, x: torch.Tensor, backend: str = "auto",
           variant: str | None = None) -> torch.Tensor:
    """Dense or HiNM-packed projection; packed rows are already consistent
    with consumers, so no runtime reorder.  `backend` and `variant` (the
    K1 variant, None = its dispatch's choice) reach the packed matmul's
    dispatch; a dense weight is a plain matmul."""
    if isinstance(p.w, PackedHiNM):
        y = kops.hinm_matmul(x, p.w, backend, variant)
    else:
        y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


def uniform_init(n_in, n_out, dtype, generator, device):
    scale = (6.0 / (n_in + n_out)) ** 0.5
    u = torch.rand((n_in, n_out), generator=generator, device=device)
    return ((u * 2.0 - 1.0) * scale).to(dtype)


def dense_init(n_in: int, n_out: int, dtype=torch.float32, bias: bool = False, *,
               generator: torch.Generator, device) -> Linear:
    b = torch.zeros((n_out,), dtype=dtype, device=device) if bias else None
    return Linear(uniform_init(n_in, n_out, dtype, generator, device), b)


class Embed(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.register_buffer("table", table)


def embed_init(vocab: int, d: int, dtype=torch.float32, *, generator, device) -> Embed:
    t = torch.randn((vocab, d), generator=generator, device=device) * 0.02
    return Embed(t.to(dtype))


def embed(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens.long()]


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` + ``bias``) parameters."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)


def rmsnorm_init(d: int, dtype=torch.float32, *, device) -> Norm:
    return Norm(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * p.scale.float()
    return out.to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, *, device) -> Norm:
    return Norm(torch.ones((d,), dtype=dtype, device=device),
                torch.zeros((d,), dtype=dtype, device=device))


def layernorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * p.scale.float() + p.bias.float()
    return out.to(x.dtype)


def get_path(tree: nn.Module, path: str):
    node = tree
    for part in path.split("/"):
        node = getattr(node, part)
    return node


def set_path(tree: nn.Module, path: str, value) -> nn.Module:
    """Set the submodule at `path` in place (modules are mutable, unlike the
    reference's functional dict update) and return the tree."""
    *parents, last = path.split("/")
    setattr(get_path(tree, "/".join(parents)) if parents else tree, last, value)
    return tree
