"""Pipeline parallelism over one mesh axis (port of
`repro.distributed.pipeline`).

A GPipe microbatch pipeline: each rank of the axis is one stage, and
microbatches stream through a single pipe register.  The schedule runs
``n_micro + n_stages - 1`` ticks; at tick t stage s applies its layers to
microbatch t - s, then every stage passes its register one stage forward
(a point-to-point send to the next rank and a receive from the previous,
the reference's `ppermute` ring).  The last stage banks each finished
microbatch, and a sum over the axis replicates the banked output.
Forward only (serving / eval), as the reference's.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.distributed import collectives as C


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Stream the microbatches ``x (n_micro, mb, ...)`` through the stages.

    `stage_fn(stage_params_s, x_mb) -> x_mb`; `stage_params` is stacked
    over a leading stage axis (each rank takes its own stage's, the
    reference's ``P(axis)`` placement), `x` is the same on every rank.
    Returns the outputs in microbatch order, the same on every rank of
    `axis`."""
    s, n_stages = C.axis_rank(mesh, axis)
    n_micro = x.shape[0]
    params = T.map(lambda a: a[s], stage_params)
    grp = C.group(mesh, axis)
    ranks = dist.get_process_group_ranks(grp)
    nxt, prv = ranks[(s + 1) % n_stages], ranks[(s - 1) % n_stages]
    reg = torch.zeros_like(x[0])
    outbuf = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        mb_id = t - s
        active = 0 <= mb_id < n_micro
        inp = x[min(max(t, 0), n_micro - 1)] if s == 0 else reg
        out = stage_fn(params, inp) if active else reg
        if s == n_stages - 1 and active:
            outbuf[mb_id] += out
        if n_stages > 1:
            recv = torch.empty_like(out)
            ops = [dist.P2POp(dist.isend, out.contiguous(), nxt, group=grp),
                   dist.P2POp(dist.irecv, recv, prv, group=grp)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            reg = recv
        else:
            reg = out
    # only the last stage banked anything: the sum replicates the result
    return C.all_reduce(outbuf, mesh, axis)
