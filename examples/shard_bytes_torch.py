"""Bytes each rank holds of a config's params under `param_specs`.

  PYTHONPATH=src python examples/shard_bytes_torch.py --arch grok_1_314b \
      --data 1 --model 4

Builds the config's params on the meta device (nothing allocated), its
packed twin (`train.abstract.abstract_packed`), and resolves both on an
abstract ("data", "model") mesh of the given sizes.  Prints, for the dense
and the packed tree, the whole tree's bytes and one rank's (every split
is even, so every rank holds the same): the sum over leaves of the
leaf's bytes over the ranks its spec splits it across.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import load_arch
from repro_torch.distributed import sharding as shd
from repro_torch.train import abstract


def tree_bytes(tree, specs, mesh) -> tuple[int, int]:
    """(whole bytes, one rank's bytes) of `tree` under `specs`."""
    view = shd.mesh_view(mesh)
    leaves, sp = shd.flatten_with_path(tree), shd.flatten_with_path(specs)
    whole = rank = 0
    for path, leaf in leaves.items():
        n = leaf.numel() * leaf.element_size()
        split = 1
        for ax in sp[path]:
            for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
                split *= view.shape[a]
        whole += n
        rank += n // split
    return whole, rank


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="grok_1_314b")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=4)
    args = ap.parse_args(argv)
    cfg = load_arch(args.arch)
    mesh = shd.abstract_mesh((args.data, args.model), ("data", "model"))
    dense = abstract.params_shape(cfg)
    packed = abstract.abstract_packed(dense, cfg)
    out = {"arch": args.arch, "mesh": mesh.shape}
    for name, tree in (("dense", dense), ("packed", packed)):
        whole, rank = tree_bytes(tree, shd.param_specs(tree, mesh, cfg), mesh)
        out[name] = {"whole_bytes": whole, "rank_bytes": rank}
        print(f"{args.arch} {name}: {whole / 1e9:.3f} GB whole, {rank / 1e9:.3f} GB a rank "
              f"on {mesh.shape}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
