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


def linear_of(node: dict, i: int | None = None) -> Linear:
    """A Linear over a params-tree node's ``w`` (and ``b``): layer i's
    views of layer-stacked leaves where `i` is given."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    b = node.get("b")
    return Linear(pick(node["w"]), None if b is None else pick(b))


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


def norm_of(node: dict, i: int | None = None) -> Norm:
    """A Norm over a params-tree node's ``scale`` (and ``bias``), as
    `linear_of`."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    bias = node.get("bias")
    return Norm(pick(node["scale"]), None if bias is None else pick(bias))


def rmsnorm_init(d: int, dtype=torch.float32, *, device) -> Norm:
    return Norm(torch.ones((d,), dtype=dtype, device=device))


# a norm's row mean (`_row_mean`): the equal parts a row is cut into, the
# multiple a row is padded to (each part a whole number of 16-byte f32
# vectors) and the most values a part may hold
ROW_PARTS = 16
ROW_ALIGN = 4 * ROW_PARTS
ROW_PART_MAX = 4096


def _row_mean(x32: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim (kept), summed in an order that does not
    depend on how many rows the call holds or where a row sits.

    PyTorch's CUDA reduction sizes its blocks from the output count: a
    block holds 512 threads, and the lanes one output gets shrink as more
    outputs share the block, so one sum over d_model 5120 runs on 128
    lanes for decode's 4 rows and on 32 for a verify's 16, and a row's bits
    follow its batch.  Here a row is cut into ROW_PARTS equal parts, each
    part averaged, then the parts' means: the first reduction has at least
    ROW_PARTS outputs, which fill a block's height whatever the row count,
    so each part gets the same lanes; the second gives each of a row's
    ROW_PARTS values a lane of its own.  That holds while one part's sum
    is not split over warps (at 8,192 values a part; ROW_PART_MAX keeps
    well below) and while every part starts on a 16-byte boundary (the
    vector loads then begin at its first value wherever the row sits):
    rows are padded with zeros to a multiple of ROW_ALIGN, and the
    padding's share of the mean is scaled back out."""
    d = x32.shape[-1]
    pad = -d % ROW_ALIGN
    if pad:
        x32 = torch.nn.functional.pad(x32, (0, pad))
    width = (d + pad) // ROW_PARTS
    if width > ROW_PART_MAX:
        raise ValueError(f"a norm over {d} values gives parts of {width} > {ROW_PART_MAX}")
    parts = x32.reshape(*x32.shape[:-1], ROW_PARTS, width).mean(dim=-1)
    mean = parts.mean(dim=-1, keepdim=True)
    return mean * ((d + pad) / d) if pad else mean


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = _row_mean(x32 * x32)
    out = x32 * torch.rsqrt(var + eps) * p.scale.float()
    return out.to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, *, device) -> Norm:
    return Norm(torch.ones((d,), dtype=dtype, device=device),
                torch.zeros((d,), dtype=dtype, device=device))


def layernorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = _row_mean(x32)
    var = _row_mean((x32 - mu) ** 2)
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
