"""Path-based sharding rules (port of `repro.distributed.sharding`).

The rules are pure Python over a mesh's axis names and sizes: `mesh_view`
reads them from a `torch.distributed.device_mesh.DeviceMesh` or from an
`AbstractMesh` (axis name -> size, no devices), so the production (16, 16)
and (2, 16, 16) meshes resolve without 512 ranks, as the reference's
`compat.abstract_mesh` does.  A spec is a `PartitionSpec` (a tuple: one
entry per tensor dim, a mesh axis name, a tuple of names, or None), the
counterpart of `jax.sharding.PartitionSpec`; `to_placements` turns one
into `torch.distributed.tensor` placements on a real mesh.

Axis roles:
  dp    : batch — ('pod', 'data') on the multi-pod mesh, ('data',) otherwise
  fsdp  : parameter sharding over 'data' (gathered on use); the pod axis is
          left out (across pods params replicate and gradients reduce over
          'pod' + 'data'), unless the config asks for `fsdp_pods`
  tp    : tensor parallel over 'model'
  heads : tp, but only when the head count divides the axis
  ep    : expert parallel over 'model' when n_experts divides it

Every role degrades to replication when the dim does not divide its axis:
the rules never produce an invalid spec.

The trees are the port's `zoo.params_of` trees (nested dicts and lists,
layer-stacked leaves), whose paths are the reference's; a packed leaf is a
`PackedHiNM` whose tensor fields (``vals``, ``vec_idx``, ``nm_idx``) are
the path's last segment.  Any object with a ``shape`` is a leaf (a tensor,
a meta tensor, a numpy array).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch import perf_knobs
from repro_torch.core.types import PackedHiNM

PACKED_FIELDS = ("vals", "vec_idx", "nm_idx")
# path segments whose leaves carry a leading layer (or period) axis
STACKED = ("blocks", "enc", "dec", "stacks")


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (the dim
    split over several axes, the first the major), or None (whole)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind it."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def abstract_mesh(sizes, names) -> AbstractMesh:
    return AbstractMesh(tuple(names), tuple(int(s) for s in sizes))


def mesh_view(mesh) -> AbstractMesh:
    """The axis names and sizes of an `AbstractMesh` or a `DeviceMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    return AbstractMesh(names, tuple(mesh.size(i) for i in range(len(names))))


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_view(mesh).axis_names else ("data",)


def _axis_size(mesh, name: str) -> int:
    # a serving mesh may be data-only: a missing axis has size 0, which
    # every divisibility check below treats as "does not fit" (replicate)
    return mesh_view(mesh).shape.get(name, 0)


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return False
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= _axis_size(mesh, a)
    else:
        n = _axis_size(mesh, axis)
    return n > 0 and dim % n == 0 and dim >= n


def _divides(n: int, mesh, name: str) -> bool:
    """Like `_fits`, for count divisibility (heads per shard)."""
    sz = _axis_size(mesh, name)
    return sz > 0 and n % sz == 0


def _resolve(role, dim: int, mesh, cfg) -> Any:
    """role -> mesh axis name (or None), honouring divisibility."""
    if role is None:
        return None
    if role == "dp":
        ax = batch_axes(mesh)
        ax = ax if len(ax) > 1 else ax[0]
        return ax if _fits(dim, mesh, ax) else None
    if role == "fsdp":
        if (cfg is not None and getattr(cfg, "fsdp_pods", False)
                and "pod" in mesh_view(mesh).axis_names and _fits(dim, mesh, ("data", "pod"))):
            return ("data", "pod")
        return "data" if _fits(dim, mesh, "data") else None
    if role in ("tp", "heads", "ep"):
        return "model" if _fits(dim, mesh, "model") else None
    raise ValueError(role)


def _packed_spec(shape: tuple[int, ...], mesh, cfg, field: str) -> P:
    """Spec of one PackedHiNM field (the layer axis already stripped): the
    tile dim T over 'model' (tiles are independent), or an expert-leading
    dim over 'model' where it divides."""
    ndim = len(shape)
    t_axis = ndim - 3 if field in ("vals", "nm_idx") else ndim - 2
    spec = [None] * ndim
    if t_axis > 0 and _fits(shape[0], mesh, "model"):  # expert dim EP
        spec[0] = "model"
        if _fits(shape[-1], mesh, "data"):
            spec[-1] = "data"
        return P(*spec)
    knobs = perf_knobs.KNOBS
    if knobs.packed_t_axes == "both" and _fits(shape[t_axis], mesh, ("model", "data")):
        spec[t_axis] = ("model", "data")
    elif _fits(shape[t_axis], mesh, "model"):
        spec[t_axis] = "model"
        if knobs.packed_t_axes != "model_only" and _fits(shape[-1], mesh, "data"):
            spec[-1] = "data"
    return P(*spec)


def _rule_for(path: str, shape: tuple[int, ...], mesh, cfg) -> tuple:
    """Role tuple of a dense param leaf."""
    nd = len(shape)
    seg = path.split("/")
    key = seg[-1]
    parent = seg[-2] if len(seg) > 1 else ""

    if key == "table":
        if perf_knobs.KNOBS.embed_feature_shard:
            return (None, "tp")
        return ("tp", "fsdp")
    if key == "scale" or (key == "bias" and nd == 1 and parent.startswith("ln")):
        return (None,) * nd
    if key == "lam":
        return ("tp",)
    if key == "conv":
        return (None, "tp")
    if key == "r":
        return (None,) * nd
    if key == "b":
        base = (None,) * (nd - 1)
        # a bias shards like its weight's output dim
        if parent == "wq":
            return base + ("heads" if cfg and _divides(cfg.n_heads, mesh, "model") else None,)
        if parent in ("wk", "wv"):
            return base + ("heads" if cfg and _divides(cfg.n_kv_heads, mesh, "model") else None,)
        if parent in ("wo", "wd", "wout"):
            return base + (None,)
        return base + ("tp",)
    if key != "w":
        return (None,) * nd

    # weight matrices, stored (n_in, n_out); expert stacks (E, n_in, n_out)
    lead = ()
    if nd == 3:
        if cfg and cfg.n_experts and _fits(shape[0], mesh, "model"):
            return ("ep", "fsdp", None)
        lead = (None,)
    if parent == "wq":
        return lead + ("fsdp", "heads" if cfg and _divides(cfg.n_heads, mesh, "model") else None)
    if parent in ("wk", "wv"):
        return lead + ("fsdp",
                       "heads" if cfg and _divides(cfg.n_kv_heads, mesh, "model") else None)
    if parent == "wo":
        return lead + ("heads" if cfg and _divides(cfg.n_heads, mesh, "model") else None,
                       "fsdp")
    if parent in ("wd", "wout"):
        return lead + ("tp", "fsdp")
    if parent == "router":
        return lead + (None, None)
    if parent == "lm_head":
        return lead + ("fsdp", "tp")
    # default projection: output dim TP, input dim FSDP
    return lead + ("fsdp", "tp")


def _spec_for_shape(path: str, shape: tuple[int, ...], mesh, cfg) -> P:
    resolved, used = [], set()
    for role, dim in zip(_rule_for(path, shape, mesh, cfg), shape):
        ax = _resolve(role, dim, mesh, cfg)
        # an axis may appear at most once in a spec
        names = ax if isinstance(ax, tuple) else (ax,)
        if ax is not None and any(a in used for a in names):
            ax = None
        if ax is not None:
            used.update(names)
        resolved.append(ax)
    return P(*resolved)


def leaf_spec(path: str, shape, mesh, cfg=None, stacked: bool | None = None) -> P:
    """The spec of one param leaf at `path` ('/'-joined): a packed field
    when the path ends in one.  A leaf under a stacked segment carries a
    leading layer axis that is never sharded (`stacked` overrides the
    path's say: a per-layer tensor of a model has none)."""
    shape = tuple(shape)
    seg = path.split("/")
    lead = any(s in seg for s in STACKED) if stacked is None else stacked
    inner = shape[1:] if lead else shape
    if seg[-1] in PACKED_FIELDS:
        spec = _packed_spec(inner, mesh, cfg, seg[-1])
    else:
        spec = _spec_for_shape(path, inner, mesh, cfg)
    return P(*((None,) + tuple(spec))) if lead else spec


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    `PackedHiNM` nodes (their tensor fields are leaves); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, PartitionSpec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    if isinstance(tree, PackedHiNM):
        return dataclasses.replace(
            tree, **{f: fn(path + (f,), getattr(tree, f)) for f in PACKED_FIELDS})
    return fn(path, tree)


def flatten_with_path(tree) -> dict[str, Any]:
    """{'/'-joined path: leaf} of `tree` (`map_with_path`'s leaves)."""
    out = {}

    def put(path, leaf):
        out["/".join(path)] = leaf
        return leaf

    map_with_path(put, tree)
    return out


def param_specs(params, mesh, cfg=None):
    """A tree matching `params` with a `PartitionSpec` at every leaf (a
    packed node's fields each get one)."""
    return map_with_path(lambda path, leaf: leaf_spec("/".join(path), leaf.shape, mesh, cfg),
                         params)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def opt_state_specs(opt_state, pspecs):
    """Specs of the optimizer state given the param specs.  AdamW: mu/nu
    mirror params; Adafactor: vr drops the last dim's axis, vc the
    second-to-last; count replicated."""
    if "mu" in opt_state:
        return {"mu": pspecs, "nu": pspecs, "count": P()}

    def fact(spec, state):
        spec = tuple(spec)
        if isinstance(state, dict) and "vr" in state:
            return {"vr": P(*spec[:-1]) if len(spec) > 1 else P(),
                    "vc": P(*(spec[:-2] + spec[-1:])) if len(spec) > 1 else P()}
        return {"v": P(*spec)}

    return {"v": _map_specs(fact, pspecs, opt_state["v"]), "count": P()}


def _map_specs(fn, specs, other):
    """``fn(spec, other_subtree)`` at every spec of `specs`."""
    if _is_spec(specs):
        return fn(specs, other)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, other[k]) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v, other[i]) for i, v in enumerate(specs))
    if isinstance(specs, PackedHiNM):
        return dataclasses.replace(specs, **{f: _map_specs(fn, getattr(specs, f),
                                                           getattr(other, f))
                                             for f in PACKED_FIELDS})
    return None


def batch_specs(batch, mesh):
    """Input batch: the leading (global batch) dim over the dp axes."""
    dp = batch_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]

    def f(_, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        if _fits(leaf.shape[0], mesh, dp):
            return P(dp, *([None] * (nd - 1)))
        return P(*([None] * nd))

    return map_with_path(f, batch)


def _cache_leaf_spec(role: str, shape, mesh, dp) -> P:
    """One decode-cache leaf's spec from its role (declared per family by
    `zoo.cache_shard_roles`):
      kv    : stripe K/V (L, B, S, KV, hd) — batch over dp, the KV heads or
              (KNOBS.decode_seq_shard) the sequence over 'model'
      page  : paged-pool leaf (L, n_pages, page, ...) — the page axis over
              dp, KV heads over 'model'; replicated under
              KNOBS.paged_attn_sharded (K2 walks the whole pool)
      slot  : per-slot bookkeeping (L, B[, ...]) — the slot axis over dp
      enc   : per-slot encoder leaves (B, ...) — batch over dp at axis 0
      state : recurrent state (L, B, feat...) — batch over dp, the last
              dim over 'model'
    Every role degrades to replication where a dim does not divide."""
    shape = tuple(shape)
    nd = len(shape)
    sp = [None] * nd
    knobs = perf_knobs.KNOBS
    if role == "kv":
        if _fits(shape[1], mesh, dp):
            sp[1] = dp
        if not knobs.decode_seq_shard and _fits(shape[3], mesh, "model"):
            sp[3] = "model"
        elif _fits(shape[2], mesh, "model"):
            sp[2] = "model"
    elif role == "page":
        if knobs.paged_attn_sharded:
            return P(*sp)
        if nd >= 2 and _fits(shape[1], mesh, dp):
            sp[1] = dp
        if nd == 5 and _fits(shape[3], mesh, "model"):
            sp[3] = "model"
    elif role == "slot":
        if nd >= 2 and _fits(shape[1], mesh, dp):
            sp[1] = dp
    elif role == "enc":
        if nd >= 1 and _fits(shape[0], mesh, dp):
            sp[0] = dp
    else:  # "state"
        if nd >= 2 and _fits(shape[1], mesh, dp):
            sp[1] = dp
        if nd >= 3 and _fits(shape[-1], mesh, "model"):
            sp[-1] = "model"
    return P(*sp)


def _infer_cache_roles(node):
    """Name-based roles for a cache without a config: a paged pool dict by
    its block table, stripe K/V by name and rank, encoder leaves by name,
    anything else recurrent state."""
    from repro_torch.models import paging

    if isinstance(node, dict):
        if paging.is_paged(node):
            return paging.paged_roles(node)
        out = {}
        for k, v in node.items():
            if isinstance(v, (dict, tuple, list)):
                out[k] = _infer_cache_roles(v)
            elif k in ("k", "v") and len(v.shape) == 5:
                out[k] = "kv"
            elif k in ("pos", "kpos"):
                out[k] = "slot"
            elif k in ("enc_out", "enc_len"):
                out[k] = "enc"
            else:
                out[k] = "state"
        return out
    if isinstance(node, (tuple, list)):
        return type(node)(_infer_cache_roles(v) for v in node)
    return "state"


def cache_specs(cache, mesh, cfg=None):
    """Decode-cache specs, stripe or paged: roles from the family
    (`zoo.cache_shard_roles`) when `cfg` is given, else inferred from leaf
    names.  Size a page-sharded pool with `paging.shard_geometry`."""
    dp = batch_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    if cfg is not None:
        from repro_torch.models import zoo

        roles = zoo.cache_shard_roles(cfg, cache)
    else:
        roles = _infer_cache_roles(cache)

    def walk(role, leaf):
        if isinstance(role, dict):
            return {k: walk(role[k], leaf[k]) for k in leaf}
        if isinstance(role, (list, tuple)):
            return type(leaf)(walk(r, x) for r, x in zip(role, leaf))
        return _cache_leaf_spec(role, leaf.shape, mesh, dp)

    return walk(roles, cache)


def role_specs(roles, specs):
    """(role, spec) of every leaf of a cache's role tree and its specs."""
    if isinstance(roles, dict):
        for k in roles:
            yield from role_specs(roles[k], specs[k])
    elif isinstance(roles, (list, tuple)):
        for r, sp in zip(roles, specs):
            yield from role_specs(r, sp)
    else:
        yield roles, specs


def to_placements(spec, mesh) -> list:
    """A spec as `torch.distributed.tensor` placements on `mesh` (a
    `DeviceMesh`): ``Shard(d)`` on each mesh dim that splits tensor dim d,
    ``Replicate()`` on the others — the counterpart of the reference's
    `to_named`.  A dim split over several axes must name them in mesh
    order (the major first), as a DTensor splits them."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_view(mesh).axis_names
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in the mesh's "
                             f"order {names}; a DTensor cannot split a dim so")
        for i in idx:
            out[i] = Shard(d)
    return out
