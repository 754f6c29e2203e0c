"""Meshes (port of `repro.launch.mesh`).

`make_production_mesh` is the reference's fixed production mesh as an
`AbstractMesh` (axis names and sizes, no devices): 16 x 16 = 256 chips
("data", "model"), or with ``multi_pod`` a "pod" axis before them (2 pods,
512 chips).  Data parallelism runs over ("pod", "data"); FSDP parameter
sharding stays inside a pod on "data".

`make_host_mesh` is a `DeviceMesh` over the ranks of the initialised
process group (one process per rank; NCCL on the card, gloo on the CPU).
Both are functions: importing this module touches no device and no group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import AbstractMesh, abstract_mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def make_host_mesh(model: int = 1, device_type: str | None = None):
    """A ("data", "model") `DeviceMesh` of shape (world // model, model)
    over the initialised group, on `device_type` (default: "cuda" under
    NCCL, else "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group "
                           "(distributed.collectives.init_process_group)")
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model axis {model} does not divide the world of {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device_type == "cuda" and dist.get_backend() != "nccl":
        raise ValueError("a CUDA mesh runs on NCCL, not on "
                         f"{dist.get_backend()!r}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=("data", "model"))
