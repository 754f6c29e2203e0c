"""A mesh at run time: the process group, the current mesh of a sharded
step, and tensors placed by their `PartitionSpec`.

The reference is one process driving every device (`jax.jit` with
shardings, `shard_map` for explicit local code).  The port is one process
per rank, each holding its own shard of every tensor: `local_shard` cuts
it by the spec and the rank's mesh coordinates, `assemble` all-gathers the
shards back into the whole tensor (the gather XLA inserts on use).  A
spec's axes split a dim major-first, as in the reference.

`MeshContext` is the counterpart of the reference's ambient mesh
(`compat.get_abstract_mesh()` inside a sharded jit): `kernels.ops` and
`models.layers` read `current()` to take their shard-local paths, and the
context says which caches hold a sequence-sharded stripe.  NCCL serves a
CUDA mesh and gloo a CPU one; nothing here catches a failed collective.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import batch_axes, mesh_view


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device, init_method: str | None = None, rank: int | None = None,
                       world_size: int | None = None, **kw) -> None:
    """Join the default process group with the device's backend.  Without
    `init_method` the environment gives it (``torchrun``'s MASTER_ADDR /
    RANK / WORLD_SIZE); `kw` goes to `torch.distributed.init_process_group`
    (``timeout``)."""
    if init_method is not None:
        kw.update(init_method=init_method, rank=rank, world_size=world_size)
    dist.init_process_group(backend_for(device), **kw)


def coords(mesh) -> dict[str, int]:
    """This rank's coordinate along each axis of a `DeviceMesh`."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


def _all_coords(mesh) -> list[dict[str, int]]:
    """Every world rank's coordinates, in rank order."""
    names = mesh.mesh_dim_names
    grid = mesh.mesh
    if grid.numel() != dist.get_world_size():
        raise ValueError(f"a mesh of {grid.numel()} ranks in a world of "
                         f"{dist.get_world_size()}: the mesh must span the world")
    out = [None] * grid.numel()
    for idx in torch.cartesian_prod(*[torch.arange(s) for s in grid.shape]).reshape(
            grid.numel(), grid.dim()).tolist():
        out[int(grid[tuple(idx)])] = dict(zip(names, idx))
    return out


def group(mesh, axis: str):
    return mesh.get_group(axis)


def axis_rank(mesh, axes) -> tuple[int, int]:
    """(this rank's index, the count) along `axes` (a name or a tuple,
    major first)."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    view, c = mesh_view(mesh), coords(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * view.shape[a] + c[a]
        n *= view.shape[a]
    return idx, n


def dp_rank(mesh) -> tuple[int, int]:
    """(index, count) of this rank's batch shard over the dp axes."""
    return axis_rank(mesh, batch_axes(mesh))


def shard_slices(shape, spec, view, where: dict[str, int]) -> tuple:
    """The slices of a tensor of `shape` that the rank at mesh coordinates
    `where` holds under `spec`."""
    out = []
    for d, dim in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        idx, n = 0, 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            idx = idx * view.shape[a] + where[a]
            n *= view.shape[a]
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split over {ax} ({n})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def is_sharded(spec) -> bool:
    return any(ax is not None for ax in spec)


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor `t` (a copy: the whole may be
    dropped)."""
    if not is_sharded(spec):
        return t
    return t[shard_slices(t.shape, spec, mesh_view(mesh), coords(mesh))].clone()


def full_shape(local_shape, spec, mesh) -> tuple:
    view = mesh_view(mesh)
    shape = list(local_shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                shape[d] *= view.shape[a]
    return tuple(shape)


def assemble(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's shard: one all-gather over the
    world, each shard placed at its rank's coordinates."""
    if not is_sharded(spec):
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    view = mesh_view(mesh)
    out = local.new_empty(full_shape(local.shape, spec, mesh))
    for part, where in zip(parts, _all_coords(mesh)):
        out[shard_slices(out.shape, spec, view, where)] = part
    return out


def gather_cat(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """`t`'s blocks of every rank along `axes` (a name or a tuple),
    concatenated along `dim` in the axes' order."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    if all(mesh_view(mesh).shape[a] == 1 for a in axes):
        return t
    if len(axes) != 1:
        raise ValueError(f"gather over several axes {axes}: flatten them in the mesh")
    g = group(mesh, axes[0])
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, t, group=g)
    return torch.cat(parts, dim=dim)


def all_reduce(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced over the ranks of `axes`, in place (and returned)."""
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        dist.all_reduce(t, op=op, group=group(mesh, a))
    return t


# ---------------------------------------------------------------------------
# the current mesh of a sharded step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshContext:
    """The mesh a sharded step runs under.  `seq_sharded`: the stripe caches
    of the step hold their sequence axis split over 'model'.  `calls`
    counts the shard-local paths taken (``"hinm_spmm_shard_map"``,
    ``"seq_parallel_decode"``), so a caller can see which ran."""

    mesh: object
    seq_sharded: bool = False
    calls: dict = dataclasses.field(default_factory=dict)

    @property
    def view(self):
        return mesh_view(self.mesh)

    def size(self, axis: str) -> int:
        return self.view.shape.get(axis, 0)

    def note(self, name: str) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1


_current: MeshContext | None = None


def current() -> MeshContext | None:
    return _current


@contextlib.contextmanager
def use(ctx: MeshContext | None):
    """Run the block under `ctx` (None: no mesh)."""
    global _current
    prev, _current = _current, ctx
    try:
        yield ctx
    finally:
        _current = prev


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (a None leaf, or a
    None spec subtree, stays None)."""
    if tree is None or specs is None:
        return None
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, specs[i]) for i, v in enumerate(tree))
    return fn(tree, specs)


def place(tree, specs, mesh):
    """Every leaf's local shard (`local_shard`) under its spec."""
    return _map2(lambda t, s: local_shard(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """Every leaf whole again (`assemble`) from the ranks' shards."""
    return _map2(lambda t, s: assemble(t, s, mesh), tree, specs)
