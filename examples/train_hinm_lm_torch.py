"""Train an LM with gradual HiNM pruning and recovery on the PyTorch/CUDA
port (`src/repro_torch`): the port's twin of `examples/train_hinm_lm.py`,
with the same flags (plus `--device`), schedule and report.

  python examples/train_hinm_lm_torch.py                     # tiny, on the GPU
  python examples/train_hinm_lm_torch.py --device cpu        # plain PyTorch path
  python examples/train_hinm_lm_torch.py --scale 100m --steps 300

The run: dense warm-up -> cubic vector-sparsity ramp to steps//3 -> the
N:M stage switches on at steps//2 with the gyro permutation refresh
(mask-only, in the original layout) -> masked-dense recovery, masks every
10 steps, in the fault-tolerant loop (async checkpoints under --ckpt,
resume from its latest).  Compare `--method noperm` to see the
permutation's effect on recovery.  The weights come from torch's
generator, so the losses are not the JAX example's.
"""
import argparse
import logging
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch


def main():
    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import zoo
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.train import gradual, loop, steps as tsteps

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--method", default="gyro", choices=["gyro", "noperm", "v1", "v2"])
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "hinm_lm_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    base = load_arch("qwen2_0_5b")
    if args.scale == "tiny":
        cfg = base.reduced(max_seq=args.seq)
    else:  # ~100M-parameter config
        cfg = base.reduced(n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
                           d_ff=2048, vocab=32000, head_dim=64,
                           max_seq=args.seq)

    gen = torch.Generator(device=args.device).manual_seed(0)
    params = zoo.params_of(cfg, zoo.init(cfg, gen, args.device))
    n_params = sum(p.numel() for p in T.leaves(params))
    print(f"model: {n_params/1e6:.1f}M params, HiNM target "
          f"{cfg.hinm.total_sparsity:.0%} sparsity, method={args.method}, "
          f"device={args.device}")

    opt = make_optimizer(cfg.optimizer)
    data = SyntheticLMData(cfg.vocab, args.seq, args.batch, seed=0, device=args.device)
    step_fn, _ = tsteps.make_train_step(
        cfg, optimizer_name=cfg.optimizer,
        lr_fn=cosine_schedule(3e-3, 10, args.steps))

    sched = gradual.GradualSchedule(
        target=cfg.hinm,
        vector_end_step=args.steps // 3,
        nm_step=args.steps // 2,
        update_every=10,
    )
    mask_cb = gradual.make_mask_schedule(cfg, sched, method=args.method)

    losses = []
    state = loop.LoopState(params=params, opt_state=opt.init(params), masks=None)
    lcfg = loop.LoopConfig(total_steps=args.steps,
                           checkpoint_every=max(args.steps // 3, 20),
                           checkpoint_dir=args.ckpt, log_every=10)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    state = loop.run(state, step_fn, data.iterator(), lcfg,
                     on_step=lambda s, m: losses.append(m.get("loss")),
                     mask_schedule=mask_cb)

    dense_best = min(losses[: args.steps // 3])
    final = float(np.mean(losses[-5:]))
    print(f"\nbest dense-phase loss : {dense_best:.4f}")
    print(f"final loss at {cfg.hinm.total_sparsity:.0%} HiNM sparsity: {final:.4f}")
    print(f"recovery gap          : {final - dense_best:+.4f}")


if __name__ == "__main__":
    main()
