"""The rank side of the port's multi-rank tests (`tests/test_torch_distributed.py`,
`tests/test_torch_sharded_serve.py`), and the reference's page-id script.

`Group` spawns one process per rank, joins them into one gloo group on a
file store in the test's temporary directory (no TCP port), runs a job
there with one torch thread each, and hands the ranks' results back.
Jobs take and return plain Python values, numpy arrays and CPU tensors;
they import the port only (`reference_pages`, run in a spawned process
of its own, is the one that imports the reference).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import traceback

import numpy as np

MAX_SEQ = 64


class Group:
    """`world` spawned ranks running `job(rank, world, payload)` (a name in
    this module).  `results()` waits for them: their results in rank
    order; a rank that raised fails it with its traceback."""

    def __init__(self, job: str, world: int, tmp_path, payload):
        ctx = multiprocessing.get_context("spawn")
        self._q = ctx.Queue()
        store = os.path.join(str(tmp_path), f"{job}.store")
        self._procs = [ctx.Process(target=_rank_main, args=(job, r, world, store, payload,
                                                            self._q))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def results(self, timeout: float = 240.0) -> list:
        out = {}
        try:
            for _ in self._procs:
                rank, ok, value = self._q.get(timeout=timeout)
                if not ok:
                    raise AssertionError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in self._procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
        return [out[r] for r in sorted(out)]


def _rank_main(job, rank, world, store, payload, q):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.distributed import collectives as C

    C.init_process_group("cpu", f"file://{store}", rank, world,
                         timeout=datetime.timedelta(seconds=120))
    try:
        value = globals()[job](rank, world, payload)
        q.put((rank, True, value))
    except BaseException:  # report to the test, which fails with it
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py
# ---------------------------------------------------------------------------


# the sharded decode's runs: each knob `shard_serve_step` or the rules it
# places by read, at its default and its other values
SERVE_KNOBS = {
    "default": {},
    "gather": dict(packed_shard_map=False, seq_parallel_decode=False),
    "heads": dict(decode_seq_shard=False),
    "tiles_both": dict(packed_t_axes="both", embed_feature_shard=True),
    "tiles_model": dict(packed_t_axes="model"),
}


def _sharded_decode(payload, mesh) -> dict:
    """Prefill on a copy of the payload's model, then four greedy decode
    steps through `shard_serve_step` on `mesh`."""
    import copy

    import torch

    from repro_torch.configs.base import load_arch
    from repro_torch.models import zoo
    from repro_torch.train import steps

    cfg = load_arch("qwen2_0_5b").reduced(**payload["serve_reduced"])
    model = copy.deepcopy(payload["serve_model"])
    cache = zoo.make_cache(cfg, payload["batch"], MAX_SEQ, device="cpu")
    last = zoo.prefill(model, cfg, torch.as_tensor(payload["prompts"]), cache)
    tok = zoo.logits_fn(model, cfg, last)[:, :cfg.vocab].argmax(-1)[:, None].int()
    _, decode_fn = steps.make_serve_steps(cfg, mesh)
    step, _, _ = steps.shard_serve_step(decode_fn, cfg, mesh, model, cache, payload["batch"])
    logits, toks = [], [tok.clone()]
    for _ in range(4):
        lg, _ = step(tok)
        full = lg.full_tensor()
        logits.append(full.numpy())
        tok = full[:, :cfg.vocab].argmax(-1)[:, None].int()
        toks.append(tok.clone())
    return dict(logits=logits, tokens=[t.numpy() for t in toks], calls=dict(step.ctx.calls),
                k_local=tuple(step.cache["k"].shape), seq_sharded=step.ctx.seq_sharded,
                tile_shard=type(step.model.blocks[0].attn.wq.w).__name__,
                table_local=tuple(step.model.embed._buffers["table"].shape))


def distributed_job(rank, world, payload):
    """On a (2, 2) ("data", "model") mesh: four decode steps through
    `shard_serve_step`, the sharded train step's first gradients and three
    AdamW steps, one run of each launch cell at a reduced shape; on a
    ("pod",) mesh of 4, `pipeline_apply`."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import perf_knobs
    from repro_torch import tree as T
    from repro_torch.configs.base import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.train import steps

    mesh = make_host_mesh(model=2, device_type="cpu")
    out = {}

    # the T-sharded K1 and sequence-parallel decode, and each distributed
    # knob's other value
    for name, kn in SERVE_KNOBS.items():
        with perf_knobs.knobs(**kn):
            out["serve", name] = _sharded_decode(payload, mesh)

    # the sharded train step
    tcfg = load_arch("qwen2_0_5b").reduced(**payload["train_reduced"])
    params = payload["train_params"]
    step_fn, opt = steps.make_train_step(tcfg)
    opt_state = opt.init(params)
    batch = SyntheticLMData(tcfg.vocab, 32, 8, seed=0, device="cpu").batch(0)
    tstep, in_specs, _ = steps.shard_train_step(step_fn, tcfg, mesh, params, opt_state,
                                                None, batch)
    pl, ol, bl = (C.place(t, s, mesh) for t, s in
                  ((params, in_specs[0]), (opt_state, in_specs[1]), (batch, in_specs[3])))
    loss, grads = tstep.value_and_grad(pl, None, bl)
    full = C.gather_tree(grads, in_specs[0], mesh)
    losses = []
    for i in range(3):
        pl, ol, metrics, _ = tstep(pl, ol, None, bl, i)
        losses.append(float(metrics["loss"]))
    out["train"] = dict(loss=float(loss), grads=shd.flatten_with_path(
        T.map(lambda g: g.numpy(), full)), losses=losses,
        local_rows=int(bl["tokens"].shape[0]))

    # every launch cell at a reduced shape
    ccfg = load_arch("qwen2_0_5b").reduced(**payload["train_reduced"])
    runs = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        cell = cells.build_cell(ccfg, shape, mesh, shape_override=(32, 4))
        res = cells.run_cell(cell, ccfg, mesh, seed=1)
        val = res["loss"] if cell.kind == "train" else res.full_tensor()
        runs[shape] = (cell.kind, np.asarray(val, dtype=np.float64))
    out["cells"] = runs

    # GPipe over ("pod",)
    pod = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    ws, bs, x = (torch.as_tensor(a) for a in payload["pipeline"])
    y = pipeline_apply(lambda p, xm: torch.tanh(xm @ p[0] + p[1]), (ws, bs), x, pod)
    out["pipeline"] = y.numpy()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_serve.py
# ---------------------------------------------------------------------------


def _sched(payload, family, layout, mesh, n_pages="auto", spec=None, **kw):
    """Drive `family`'s workload (`payload["workloads"]`) through the
    port's Scheduler on `mesh`, as `serve_conformance.scheduler_tokens`
    (or `share_tokens` with ``workload="share"``) does."""
    from repro_torch import serve
    from repro_torch.configs.base import load_arch

    c = payload["cases"][family]
    cfg = load_arch(c["arch"]).reduced(**c["reduced"])
    prompts, embeds = payload["workloads"][kw.pop("workload", family)]
    skw = dict(cache_kw=c.get("cache_kw"))
    if layout == "paged":
        skw.update(page=c["page"], n_pages=n_pages)
    else:
        skw.update(page=None, bucket=False)
    skw.update(kw)
    sched = serve.Scheduler(cfg, payload["models"][family], max_slots=4, max_seq=MAX_SEQ,
                            decode_chunk=4, mesh=mesh, spec=spec, flightrec=True,
                            device="cpu", **skw)
    reqs = [serve.Request(rid=i, prompt=p,
                          params=serve.SamplingParams(max_new_tokens=c["max_new"]),
                          embeds=None if embeds is None else embeds[i], arrival=i)
            for i, p in enumerate(prompts)]
    sched.run(reqs)
    return [r.tokens for r in reqs], sched


def _facts(s) -> dict:
    """What the reference's harness asserts of a run, as values."""
    from repro_torch.distributed import sharding as shd

    kv, st = s.kv, s.stats
    reg = s.telemetry.registry
    config = next(e for e in s.flight.events if e.kind == "config").data
    dispatch = next(e for e in s.flight.events if e.kind == "dispatch").data
    pool = next((p for p in _pools(kv.cache)), None)
    return dict(
        paged=kv.paged, bucket=s.bucket, page_shards=len(kv._free_pages) if kv.paged else 0,
        specs=kv.specs is not None, drained=kv.n_free_pages == kv.n_alloc_pages,
        n_pages=kv.n_pages if kv.paged else None,
        local_pages=None if pool is None else int(pool["k"].shape[1]),
        pool_specs=None if pool is None else [tuple(sp) for sp in _pool_specs(kv.specs)],
        paged_attn=s.paged_attn, sharded=config["sharded"], graphs=config.get("graphs"),
        defer=dispatch["defer"],
        deferred=reg.counter("serve_paged_attn_deferred",
                             labels={"reason": "page-sharded-pool"}).value,
        eager=reg.counter("serve_eager_programs", labels={"reason": "mesh"}).value,
        verify_steps=st.verify_steps, decode_tokens=st.decode_tokens,
        spec_dispatches=reg.counter("serve_spec_dispatches").value,
        spec_cycles=getattr(s, "_spec_cycles", None),
        fused=None if s.spec is None else bool(s.spec.fused),
        draft=(st.draft_proposed, st.draft_accepted),
        prefix_hit_tokens=st.prefix_hit_tokens, cow=kv.cow_copies if kv.paged else 0,
        conserved=(kv.n_free_pages + kv.n_referenced_pages == kv.n_alloc_pages),
        prefill_chunks=st.prefill_chunks, prefix=s.prefix is not None,
        lanes=(s._lanes_lo, s._lanes_hi), dp=shd.batch_axes(s.mesh))


def _pools(tree):
    from repro_torch.models import paging

    if paging.is_paged(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _pools(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _pools(v)


def _pool_specs(specs):
    for node in _pools(specs):
        return [node["k"], node["bt"]]
    return []


def _pristine_after_clear(s) -> bool:
    """Drop the prefix index; then every page is free and swept."""
    import torch

    from repro_torch.models import paging

    s.clear_prefix_cache()
    kv = s.kv
    kpos = kv.cache["kpos"]
    swept = bool((kpos[:, paging.N_RESERVED:] == paging.KPOS_SENTINEL).all())
    return kv.n_free_pages == kv.n_alloc_pages and swept and isinstance(kpos, torch.Tensor)


def sharded_serve_job(rank, world, payload):
    """The reference's sharded serving cases (`serve_conformance`'s
    `_drive` modes) on a data-only mesh of `world` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import perf_knobs, serve

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    out = {}
    for fam in ("transformer", "hybrid", "encdec"):
        paged, sp = _sched(payload, fam, "paged", mesh)
        stripe, ss = _sched(payload, fam, "stripe", mesh)
        out["conformance", fam] = dict(paged=paged, stripe=stripe, facts=_facts(sp),
                                       stripe_facts=_facts(ss))
        if fam == "transformer":
            tight, st = _sched(payload, fam, "paged", mesh, n_pages=6)
            out["conformance", fam].update(tight=tight, tight_facts=_facts(st))
        for layout in ("paged", "stripe"):
            fused, sf = _sched(payload, fam, layout, mesh, spec=serve.SpecConfig(k=3))
            unfused, su = _sched(payload, fam, layout, mesh,
                                 spec=serve.SpecConfig(k=3, fused=False))
            out["spec", fam, layout] = dict(fused=fused, unfused=unfused, facts=_facts(sf),
                                            unfused_facts=_facts(su))
    # prefix sharing, copy-on-write and chunked prefill on the page-sharded pool
    share = dict(workload="share", prefix_share="auto")
    off, s_off = _sched(payload, "transformer", "paged", mesh, **dict(share, prefix_share=False))
    on, s_on = _sched(payload, "transformer", "paged", mesh, **share)
    on_facts = _facts(s_on)
    pristine = _pristine_after_clear(s_on)
    page = payload["cases"]["transformer"]["page"]
    ch, s_ch = _sched(payload, "transformer", "paged", mesh, prefill_chunk=page, **share)
    sk, s_sk = _sched(payload, "transformer", "paged", mesh, spec=serve.SpecConfig(k=3),
                      prefill_chunk=page, **share)
    out["share"] = dict(off=off, on=on, chunked=ch, spec=sk, on_facts=on_facts,
                        pristine=pristine, chunked_facts=_facts(s_ch), spec_facts=_facts(s_sk))
    # speculation x chunked prefill x sharing
    soff, s_soff = _sched(payload, "transformer", "paged", mesh, spec=serve.SpecConfig(k=3),
                          **dict(share, prefix_share=False))
    son, s_son = _sched(payload, "transformer", "paged", mesh, spec=serve.SpecConfig(k=3),
                        **share)
    runs = {}
    for name, kw in (("fused", dict(spec=serve.SpecConfig(k=3))),
                     ("unfused", dict(spec=serve.SpecConfig(k=3, fused=False))),
                     ("sync", dict(spec=serve.SpecConfig(k=3), async_admission=False))):
        toks, s = _sched(payload, "transformer", "paged", mesh, prefill_chunk=page,
                         **dict(share, **kw))
        runs[name] = (toks, _facts(s))
    out["specshare"] = dict(off=soff, on=son, off_facts=_facts(s_soff), on_facts=_facts(s_son),
                            runs=runs)
    # the reference's K2 cases: a page-sharded pool (which defers it in the
    # reference) and the replicated pools of `KNOBS.paged_attn_sharded`
    for name, kn in (("downgrade", {}), ("replicated", dict(paged_attn_sharded=True))):
        with perf_knobs.knobs(**kn):
            toks, s = _sched(payload, "transformer", "paged", mesh)
            stoks, ss = _sched(payload, "transformer", "paged", mesh,
                               spec=serve.SpecConfig(k=3))
        out["kernel", name] = dict(tokens=toks, spec=stoks, facts=_facts(s),
                                   spec_facts=_facts(ss))
    # the pool's accounting under random churn
    out["churn"] = {seed: churn(payload, mesh, seed) for seed in (0, 1, 2)}
    # xlstm: a requested page falls back to stripes, sharded by slot
    toks, s = _sched(payload, "ssm", "paged", mesh)
    out["xlstm"] = dict(tokens=toks, facts=_facts(s))
    # page ids handed out by an alloc / free script
    out["pages"] = {seed: alloc_script(_pool_for_script(payload, mesh), seed)
                    for seed in (0, 1)}
    return out


def _pool_for_script(payload, mesh):
    from repro_torch import serve
    from repro_torch.configs.base import load_arch

    c = payload["cases"]["transformer"]
    cfg = load_arch(c["arch"]).reduced(**c["reduced"])
    return serve.SlotKVCache(cfg, 4, MAX_SEQ, page=8, n_pages=13, device="cpu", mesh=mesh)


def alloc_script(kv, seed: int, n_ops: int = 30, template=None, full=None) -> list:
    """Random admissions (rows and reserve drawn from `seed`) and releases
    on `kv`; returns the page list of every admission, in order.  Shared
    by the port's pool and the reference's (`reference_pages`)."""
    rng = np.random.default_rng(seed)
    tpl = kv.template(1) if template is None else template
    live, pages = [], []
    for _ in range(n_ops):
        if kv.n_free > 0 and (not live or rng.random() < 0.6):
            rows = int(rng.integers(1, 33))
            reserve = min(MAX_SEQ, rows + int(rng.integers(0, 16)))
            if not kv.can_admit(reserve):
                continue
            slot = kv.acquire()
            kv.insert(slot, tpl, rows, reserve=reserve)
            live.append(slot)
            pages.append((slot, [int(p) for p in kv.slot_pages(slot)]))
        elif live:
            slot = live.pop(int(rng.integers(0, len(live))))
            kv.release(slot)
    return pages


def reference_packed_tree(cfg, model, tree):
    """The reference's params tree of a port model packed by the port:
    `tree` (its dense `params_of`, as jax arrays) with every planned
    weight the reference's `PackedHiNM` of the model's per-layer packed
    fields, stacked over layers."""
    import jax.numpy as jnp

    from repro.core.types import HiNMConfig, PackedHiNM
    from repro_torch.models import module as M
    from repro_torch.models import zoo
    from repro_torch.train import pruning

    for key, node in zoo.perm_graph(cfg).instances():
        ws = [M.get_path(blk, node.path).w for blk in getattr(model, key)]
        h = ws[0].config
        pruning.get_node(tree, key, node.path)["w"] = PackedHiNM(
            *(jnp.asarray(np.stack([getattr(w, f).numpy() for w in ws]))
              for f in ("vals", "vec_idx", "nm_idx")),
            n_out=ws[0].n_out, n_in=ws[0].n_in,
            config=HiNMConfig(v=h.v, n=h.n, m=h.m, vector_sparsity=h.vector_sparsity))
    return tree


def reference_pages(seeds, q):
    """The reference's `SlotKVCache(mesh=)` on 4 fake host devices under the
    same alloc / free script: its page lists per seed (run in a spawned
    process: the device count is fixed at the first jax import)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        from repro import compat
        from repro.configs.base import load_arch
        from repro.serve import SlotKVCache

        import serve_conformance as sc

        c = sc._CASES["transformer"]
        cfg = load_arch(c["arch"]).reduced(**c["reduced"])
        mesh = compat.make_mesh((4,), ("data",))
        res = {}
        for seed in seeds:
            kv = SlotKVCache(cfg, 4, MAX_SEQ, page=8, n_pages=13, mesh=mesh)
            res[seed] = (alloc_script(kv, seed), kv.n_pages, kv.page_sharded,
                         len(kv._free_pages))
        q.put((True, res))
    except BaseException:
        q.put((False, traceback.format_exc()))


def churn(payload, mesh, seed: int, n_ops: int = 40) -> dict:
    """`tests/test_torch_prefix.py`'s churn twin on the sharded pool: random
    admit / map with copy-on-write / rollback / release, held at every step
    to a host refcount model."""
    import torch

    from repro_torch import serve
    from repro_torch.configs.base import load_arch
    from repro_torch.models import paging

    c = payload["cases"]["transformer"]
    cfg = load_arch(c["arch"]).reduced(**c["reduced"])
    kv = serve.SlotKVCache(cfg, 4, MAX_SEQ, page=8, n_pages=10, device="cpu", mesh=mesh)
    assert kv.paged and kv.n_pages == 12 and len(kv._free_pages) == world_of(mesh)
    bytes0 = kv.pool_bytes()
    tpl = kv.template(1)
    ar = torch.arange(MAX_SEQ, dtype=torch.int32)
    rng = np.random.default_rng(seed)
    live: dict[int, list[int]] = {}
    model_ref: dict[int, int] = {}

    def check():
        for p in range(paging.N_RESERVED, kv.n_pages):
            assert kv.page_ref(p) == model_ref.get(p, 0), p
        n_ref = sum(1 for v in model_ref.values() if v > 0)
        assert kv.n_free_pages == kv.n_alloc_pages - n_ref
        assert kv.n_referenced_pages == n_ref
        assert kv.pool_bytes() == bytes0

    def rows_on_device(slot):
        kpos = kv.cache["kpos"][0]
        bt = kv.cache["bt"][0, slot]
        alloc = int(kv.cache["alloc"][0, slot])
        rows = [int(kpos[bt[p // kv.page], p % kv.page]) for p in range(alloc * kv.page)]
        return [i for i, r in enumerate(rows) if r != paging.KPOS_SENTINEL]

    for _ in range(n_ops):
        roll = rng.random()
        can_roll = [s for s in sorted(live) if live[s][0] - live[s][2] >= 1]
        donors = [s for s in sorted(live) if live[s][0] >= kv.page]
        if can_roll and roll < 0.25:
            slot = int(rng.choice(can_roll))
            rows_now, _, floor = live[slot]
            n_spec = int(rng.integers(1, min(rows_now - floor, 6) + 1))
            keep_n = int(rng.integers(0, n_spec + 1))
            pos0 = np.zeros((kv.n_slots,), np.int32)
            keep = np.zeros((kv.n_slots,), np.int32)
            for s, (r, _, _) in live.items():
                pos0[s] = r
            pos0[slot], keep[slot] = rows_now - n_spec, keep_n
            free_before = kv.n_free_pages
            kv.rollback(pos0, keep, n_spec)
            live[slot][0] = rows_now - n_spec + keep_n
            kv.slot_len[slot] = live[slot][0]
            assert kv.n_free_pages == free_before
            assert int(kv.cache["pos"][0, slot]) == live[slot][0]
        elif donors and kv.n_free > 0 and 0.25 <= roll < 0.45:
            donor = int(rng.choice(donors))
            d_rows = live[donor][0]
            d_pages = kv.slot_pages(donor)
            n_share = int(rng.integers(1, d_rows // kv.page + 1))
            shared = d_pages[:n_share]
            shared_rows = n_share * kv.page
            cow_src, cow_rows = None, 0
            rem = d_rows - shared_rows
            if rem > 0 and rng.random() < 0.5:
                cow_src = d_pages[n_share]
                cow_rows = int(rng.integers(1, rem + 1))
            mapped = shared_rows + cow_rows
            reserve = min(MAX_SEQ, mapped + int(rng.integers(1, 16)))
            n_fresh = kv.pages_needed(reserve) - n_share
            if n_fresh < 1 or n_fresh > kv.n_free_pages or cow_rows > kv.page:
                check()
                continue
            slot = kv.acquire()
            pages = kv.map_slot(slot, shared, shared_rows, reserve, cow_src=cow_src,
                                cow_rows=cow_rows)
            assert pages[:n_share] == shared
            for p in pages:
                model_ref[p] = model_ref.get(p, 0) + 1
            live[donor][2] = max(live[donor][2], shared_rows)
            live[slot] = [mapped, reserve, mapped]
        elif kv.n_free > 0 and (not live or roll < 0.65):
            rows = int(rng.integers(1, 33))
            reserve = min(MAX_SEQ, rows + int(rng.integers(0, 16)))
            if not kv.can_admit(reserve):
                check()
                continue
            slot = kv.acquire()
            stripe = dict(tpl, kpos=torch.where(ar[None, None, :] < rows, ar[None, None, :],
                                                paging.KPOS_SENTINEL).expand_as(tpl["kpos"]),
                          pos=torch.full_like(tpl["pos"], rows))
            kv.insert(slot, stripe, rows, reserve=reserve)
            live[slot] = [rows, reserve, 0]
            for p in kv.slot_pages(slot):
                assert model_ref.get(p, 0) == 0
                model_ref[p] = 1
        elif live:
            slot = int(rng.choice(sorted(live)))
            pages = kv.slot_pages(slot)
            kv.release(slot)
            live.pop(slot)
            for p in pages:
                model_ref[p] -= 1
        check()
    rows_ok = all(rows_on_device(s) == list(range(r)) for s, (r, _, _) in live.items())
    for slot in sorted(live):
        for p in kv.slot_pages(slot):
            model_ref[p] -= 1
        kv.release(slot)
    kpos = kv.cache["kpos"]
    swept = bool((kpos[:, paging.N_RESERVED:] == paging.KPOS_SENTINEL).all()
                 and (kpos[:, paging.SENTINEL_PAGE] == paging.KPOS_SENTINEL).all())
    return dict(rows_ok=rows_ok, refs_zero=all(v == 0 for v in model_ref.values()),
                drained=kv.n_free_pages == kv.n_alloc_pages and kv.n_free == kv.n_slots,
                swept=swept, local_pages=int(kv.cache["k"].shape[1]))


def world_of(mesh) -> int:
    return mesh.size()
