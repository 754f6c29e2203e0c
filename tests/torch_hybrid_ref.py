"""The reference package's side of `tests/test_torch_hybrid.py`, run in
worker processes of its own.

Its runs are mostly Python (tracing the reference's programs, its
scheduler's host loop; its prune alone compiles some 270 programs), so
threads beside the port's tests would take turns on one interpreter
lock: `test_torch_hybrid`'s fixture starts these in three spawned
processes instead, which run beside it.  Each function takes and returns
numpy arrays and plain Python values only.
"""
import jax
import jax.numpy as jnp
import numpy as np

import serve_conformance as sc

CASE = sc._CASES["hybrid"]
ITERS = (2, 2)
# tests/test_prune_model.py's hybrid config (5 layers: stacks of 2 / 2 / 1)
# with recurrentgemma's MQA (KV 1) and d_ff = d_model: the reference's
# prune then compiles 268 programs (12 s) where at KV 2 and d_ff 128 it
# compiled 490 (16 s)
PRUNE = dict(name="hybrid", family="hybrid", block_pattern=("rec", "rec", "attn"), window=16,
             rglru_dim=64, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=64,
             vocab=256, head_dim=16, max_seq=64)
HINM = dict(v=8, n=2, m=4, vector_sparsity=0.5)
SCHED = dict(max_slots=4, max_seq=sc.MAX_SEQ, decode_chunk=4, page=CASE["page"], flightrec=True)
# the rollback cases: 4 verify steps over these positions of a 16-row ring
# (lanes 0 and 1 wrap mid-verify), keeping 0, 2 and 4 of them
RING_POS = (14, 30, 5)
KEEP = (0, 2, 4)
N_PAGES = 2 + 12


def requests(mod, prompts, max_new=CASE["max_new"]):
    return [mod.Request(rid=i, prompt=p, arrival=i,
                        params=mod.SamplingParams(max_new_tokens=max_new))
            for i, p in enumerate(prompts)]


def model_runs(overrides: dict, tree: dict, x: dict) -> dict:
    """In one jitted program, on recurrentgemma-9b `reduced(**overrides)`
    with the weights `tree`: layer 0's RG-LRU block with and without the
    random state ``x["state"]``, the eval forward, a prefill from the
    pristine cache and two decode steps (logits and the cache after
    them)."""
    from repro.configs.base import load_arch
    from repro.models import rglru, zoo

    cfg = load_arch("recurrentgemma_9b").reduced(**overrides)

    def run(params, x):
        layer = jax.tree.map(lambda a: a[0], params["stacks"][0])["kind_rec"]
        out = {"block": rglru.rglru_block(layer, cfg, x["x"])[0],
               "block cached": rglru.rglru_block(layer, cfg, x["x"], x["state"])}
        out["forward"] = zoo.forward(params, cfg, x["tokens"])
        cache = zoo.make_cache(cfg, 2, sc.MAX_SEQ)
        out["prefill"], cache = zoo.prefill(params, cfg, x["tokens"], cache)
        logits = []
        for tok in x["decode"]:
            lg, cache = zoo.decode_step(params, cfg, tok, cache)
            logits.append(lg)
        out["decode"], out["cache"] = jnp.stack(logits), cache
        return out

    return jax.tree.map(np.asarray, jax.jit(run)(jax.tree.map(jnp.asarray, tree),
                                                 jax.tree.map(jnp.asarray, x)))


def harness(tree: dict, prompts) -> dict:
    """The harness's recorded paged scheduler run
    (`scheduler_tokens("hybrid", "paged")`) with the weights `tree` (its
    model's, `serve_conformance._model`): the tokens and the flight
    record's events as (seq, kind, t, data); then `rollbacks`."""
    from repro import serve as jserve
    from repro.configs.base import load_arch

    jcfg = load_arch(CASE["arch"]).reduced(**CASE["reduced"])
    sched = jserve.Scheduler(jcfg, jax.tree.map(jnp.asarray, tree), **SCHED)
    reqs = requests(jserve, prompts)
    sched.run(reqs)
    return dict(tokens=[r.tokens for r in reqs],
                events=[(e.seq, e.kind, e.t, e.data) for e in sched.flight.events],
                rollbacks=rollbacks())


def all_model_runs(runs: dict) -> dict:
    """`model_runs` of each of `runs` ({name: (overrides, tree, x)})."""
    return {name: model_runs(*args) for name, args in runs.items()}


def ring(layout: str, seed: int = 5) -> dict:
    """One attention stack of L 2, B 3, KV 2, hd 4 on a 16-row ring (pages
    of 4, shuffled, for "paged"), every lane's last 16 positions live
    below RING_POS; the 4 verify steps' K and V rows; the recurrent
    states of `select_state` (4 snapshots and the final state)."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(RING_POS, np.int32)
    kpos = np.full((2, 3, 16), 2**30, np.int32)
    for b, p in enumerate(pos):
        for q in range(max(0, p - 16), p):
            kpos[:, b, q % 16] = q
    k, v = (rng.standard_normal((2, 3, 16, 2, 4)).astype(np.float32) for _ in range(2))
    cache = dict(k=k, v=v, kpos=kpos, pos=np.repeat(pos[None], 2, 0))
    if layout == "paged":
        pages = rng.permutation(np.arange(2, N_PAGES)).reshape(3, 4).astype(np.int32)
        pool = dict(k=np.zeros((2, N_PAGES, 4, 2, 4), np.float32),
                    v=np.zeros((2, N_PAGES, 4, 2, 4), np.float32),
                    kpos=np.full((2, N_PAGES, 4), 2**30, np.int32))
        for name in pool:
            for b in range(3):
                pool[name][:, pages[b]] = cache[name][:, b].reshape(
                    (2, 4, 4) + cache[name].shape[3:])
        cache = dict(pool, pos=cache["pos"], bt=np.repeat(pages[None], 2, 0),
                     alloc=np.full((2, 3), 4, np.int32))
    rows = {name: rng.standard_normal((4, 2, 3, 2, 4)).astype(np.float32) for name in "kv"}
    states = rng.standard_normal((4, 2, 3, 5)).astype(np.float32)
    final = rng.standard_normal((2, 3, 5)).astype(np.float32)
    return dict(cache=cache, rows=rows, states=states, final=final)


def rollbacks() -> dict:
    """`ring`'s cases through the reference's helpers, per layout: each
    step's `snapshot_attn_row`, then a decode write at `_row_loc_at`; the
    cache `restore_attn_rows` leaves keeping KEEP; and `select_state`."""
    from repro.models import paging

    out = {}
    for layout in ("paged", "stripe"):
        case = ring(layout)
        cache = {n: jnp.asarray(a) for n, a in case["cache"].items()}
        pos0 = cache["pos"][0]
        snaps = []
        for i in range(4):
            snaps.append(paging.snapshot_attn_row(cache, window=True))
            ii, jj = paging._row_loc_at(cache, cache["pos"][0], True)
            for name in "kv":
                cache[name] = cache[name].at[:, ii, jj].set(case["rows"][name][i])
            cache["kpos"] = cache["kpos"].at[:, ii, jj].set(cache["pos"][0])
            cache["pos"] = cache["pos"] + 1
        stack = jax.tree.map(lambda *xs: jnp.stack(xs), *snaps)
        restored = paging.restore_attn_rows(cache, stack, pos0, jnp.asarray(KEEP, jnp.int32), 4,
                                            window=True)
        out[layout] = jax.tree.map(np.asarray, dict(
            snaps=snaps, restored=restored,
            state=paging.select_state(jnp.asarray(case["states"]), jnp.asarray(case["final"]),
                                      jnp.asarray(KEEP, jnp.int32))))
    return out


def prune(tree: dict) -> dict:
    """The reference's `prune_model` (gyro 2/2, then noperm) of PRUNE's
    config with the weights `tree`: {method: (masks, per_layer)}."""
    from repro.configs.base import ArchConfig
    from repro.core.types import HiNMConfig
    from repro.train import pruning

    cfg = ArchConfig(**PRUNE, dtype=jnp.float32, hinm=HiNMConfig(**HINM))
    params = jax.tree.map(jnp.asarray, tree)
    out = {}
    for method in ("gyro", "noperm"):
        _, masks, _, rep = pruning.prune_model(params, cfg, method=method, ocp_iters=ITERS[0],
                                               icp_iters=ITERS[1], workers=4)
        out[method] = (jax.tree.map(np.asarray, masks), list(rep.per_layer))
    return out
