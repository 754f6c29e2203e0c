"""Training launcher (port of `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --scale tiny --steps 200 --batch 8 --seq 256 --gradual --device cpu

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --scale tiny --steps 20 --device cpu

One process per rank.  Under ``torchrun`` the process group comes from
its environment; alone, the launcher starts a one-rank group on a file
store in a fresh temporary directory.  The backend follows ``--device``:
NCCL on the card (the default, ``cuda``), gloo on the CPU.  The mesh is
``make_host_mesh()`` (every rank on "data", as the reference's); params
and optimizer state are stored by `param_specs` (their FSDP dims split
over "data"), the batch over dp; the step gathers the shards and
computes on whole trees (`steps.shard_train_step`).  HiNM
gradual pruning runs past ``--nm-step``; ``--method noperm`` ablates the
permutation.  Each rank checkpoints its own shards under
``<checkpoint-dir>/rank-<r>``.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile


def main(argv=None) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.device import resolve_device
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.train import gradual, loop, steps as tsteps

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--gradual", action="store_true")
    ap.add_argument("--method", default="gyro",
                    choices=["gyro", "noperm", "v1", "v2", "icp_only", "ocp_only"])
    ap.add_argument("--nm-step", type=int, default=-1)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = resolve_device(args.device)
    if "RANK" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        C.init_process_group(device)
    else:
        store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_launch_"), "store")
        C.init_process_group(device, f"file://{store}", rank=0, world_size=1)
    rank = dist.get_rank()
    mesh = make_host_mesh(device_type=device.type)

    cfg = load_arch(args.arch)
    if args.scale == "tiny":
        cfg = cfg.reduced(max_seq=args.seq)
    # the same seeded weights on every rank; each keeps its shards
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = zoo.params_of(cfg, zoo.init(cfg, gen, device=device))
    opt = make_optimizer(cfg.optimizer)
    opt_state = opt.init(params)
    masks = T.map(lambda _: None, params)  # dense until the schedule fires

    data = SyntheticLMData(cfg.vocab, args.seq, args.batch, seed=args.seed, device=str(device))
    lr_fn = cosine_schedule(args.lr, warmup=20, total=args.steps)
    step_fn, _ = tsteps.make_train_step(cfg, optimizer_name=cfg.optimizer, lr_fn=lr_fn)
    step, (pspecs, ospecs, _, bspecs, _, _), _ = tsteps.shard_train_step(
        step_fn, cfg, mesh, params, opt_state, params, data.batch(0))
    mspecs = pspecs

    def batch_iter():
        for b in data.iterator():
            yield C.place(b, bspecs, mesh)

    mask_schedule = None
    if args.gradual:
        nm_step = args.nm_step if args.nm_step > 0 else args.steps // 2
        sched = gradual.GradualSchedule(target=cfg.hinm, vector_end_step=nm_step * 2 // 3,
                                        nm_step=nm_step)
        whole = gradual.make_mask_schedule(cfg, sched, method=args.method)

        def mask_schedule(i, st):
            # masks from the whole weights, then each rank keeps its shards
            full = loop.LoopState(params=C.gather_tree(st.params, pspecs, mesh),
                                  opt_state=None, masks=None, step=st.step)
            new = whole(i, full)
            return None if new is None else C.place(new, mspecs, mesh)

    state = loop.LoopState(params=C.place(params, pspecs, mesh),
                           opt_state=C.place(opt_state, ospecs, mesh), masks=masks)
    lcfg = loop.LoopConfig(
        total_steps=args.steps,
        checkpoint_every=max(args.steps // 4, 25),
        checkpoint_dir=os.path.join(args.checkpoint_dir, f"rank-{rank}"),
        recover=False,
    )
    final = loop.run(state, step, batch_iter(), lcfg, mask_schedule=mask_schedule)
    print(f"done at step {final.step}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
