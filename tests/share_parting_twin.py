"""CPU twin of a sampled parting under prefix sharing (ROADMAP Queue 3).

On the card, chip_smoke's share workload with the served qwen2-0.5b cut to
12 layers parted request 3 (T 0.8, top-k 16, seed 3) from its sharing-off
stream.  This one-off script asks whether the port parts where the
reference does not: one set of weights (full-width qwen2-0.5b cut to 12
layers, the port's seeded init on the CPU, bf16, packed with no
permutation by the reference and carried to the port by
`params_from_numpy`) serves chip_smoke's share workload (12 requests, nine
over one 72-token system prompt, three over its first 32 tokens; every
fourth sampled) through the reference's `Scheduler` and the port's, prefix
sharing off and on, `Scheduler(max_slots=4, max_seq=256, page=16,
decode_chunk=8)`.  It prints each run's first divergence from the others,
request 3's streams, and where the port's runs part from the reference's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/share_parting_twin.py

Not a tier-1 test: it runs a full-width model (~10 min on a few cores).
"""
import concurrent.futures
import dataclasses
import sys
import time

import jax
import numpy as np
import torch

from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.models import zoo as jzoo
from repro_torch import serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import zoo

LAYERS = 12
SHARE_REQUESTS, SHARE_SYSTEM, SHARE_HEAD, SHARE_LONG = 12, 72, 32, (2, 6, 10)
GEOM = dict(max_slots=4, max_seq=256, page=16, decode_chunk=8)
REQ = 3


def share_prompts(vocab):
    """chip_smoke's share workload prompts (`chip_smoke.share_prompts`)."""
    rng = np.random.default_rng(4)
    system = rng.integers(0, vocab, SHARE_SYSTEM).astype(np.int32)
    out = []
    for i in range(SHARE_REQUESTS):
        if i in SHARE_LONG:
            head, n_tail = system[:SHARE_HEAD], int(rng.integers(140, 181))
        else:
            head, n_tail = system, int(rng.integers(12, 41))
        out.append(np.concatenate([head, rng.integers(0, vocab, n_tail).astype(np.int32)]))
    return out


def share_requests(mod, prompts):
    return [mod.Request(rid=i, prompt=p, arrival=i, params=mod.SamplingParams(
        max_new_tokens=24, temperature=0.8 if i % 4 == 3 else 0.0,
        top_k=16 if i % 4 == 3 else 0, seed=i)) for i, p in enumerate(prompts)]


def first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def main() -> int:
    t0 = time.perf_counter()
    cfg = dataclasses.replace(load_arch("qwen2_0_5b"), n_layers=LAYERS)
    jcfg = dataclasses.replace(jload_arch("qwen2_0_5b"), n_layers=LAYERS)
    dense = zoo.params_of(cfg, zoo.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    dense = jax.tree.map(lambda t: np.asarray(t.view(torch.uint16).numpy()).view(
        jax.numpy.bfloat16) if t.dtype == torch.bfloat16 else t.numpy(), dense)
    packed = jax.tree.map(np.asarray, jax.jit(jzoo.pack_params, static_argnums=0)(jcfg, dense))
    model = params_from_numpy(cfg, packed, "cpu")
    prompts = share_prompts(cfg.vocab)
    print(f"weights ready in {time.perf_counter() - t0:.1f} s", flush=True)

    def reference(share):
        sched = jserve.Scheduler(jcfg, packed, prefix_share=share, **GEOM)
        reqs = share_requests(jserve, prompts)
        sched.run(reqs)
        return [r.tokens for r in reqs], sched.stats.prefix_hit_tokens

    def port(share):
        sched = serve.Scheduler(cfg, model, prefix_share=share, device="cpu", **GEOM)
        reqs = share_requests(serve, prompts)
        sched.run(reqs)
        return [r.tokens for r in reqs], sched.stats.prefix_hit_tokens

    runs = {}
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = {("reference", s): ex.submit(reference, s) for s in (False, True)}
        for s in (False, True):
            runs[("port", s)] = port(s)
            print(f"port sharing {s}: done at {time.perf_counter() - t0:.1f} s", flush=True)
        runs.update({k: f.result() for k, f in futs.items()})
    for (side, share), (toks, hits) in sorted(runs.items()):
        print(f"{side:9s} sharing {str(share):5s}: prefix-hit rows {hits}; request {REQ}: "
              f"{toks[REQ]}")
    print("first divergence of each request (None: equal):")
    pairs = ((("reference", False), ("reference", True)), (("port", False), ("port", True)),
             (("reference", False), ("port", False)), (("reference", True), ("port", True)))
    for a, b in pairs:
        d = [first_divergence(x, y) for x, y in zip(runs[a][0], runs[b][0])]
        print(f"  {a[0]} sharing {a[1]} vs {b[0]} sharing {b[1]}: {d}")
    print(f"wall {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
