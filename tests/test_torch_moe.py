"""Port parity: the MoE family (`repro_torch.models.moe`, the expert-stack
paths of `zoo`, `convert`, `perm` and `train.pruning`, K1 over an expert
stack, serving) against `repro`.

Model: granite-3.0-moe `reduced(**RED)` (2 layers, d_model 64, 4 experts,
top-2, d_ff 64, V 8, f32).  Its weights are the port's seeded init laid
out as the reference's params tree (`zoo.params_of`); the reference packs
them, and they cross back through `params_from_numpy`.

- `moe_apply` gives the reference's output within 1e-4 and its routing
  (top-k experts, queue positions, capacity keeps) equal, at the default
  capacity factor and at one low enough that the reference drops;
  `aux_load_balance_loss` within 1e-6.
- K1's plain versions over an expert stack give the reference's Pallas
  kernel (interpret mode) under `jax.vmap` over the experts.
- `pack_params` / `unpack_params` of the expert stacks are bit-equal to
  the reference's.
- `prune_model` (gyro 2/2) gives the reference's retained saliency within
  1e-5, and its masks per expert when the search scores with the
  reference's own cost helpers (`reference_search_costs`: on its own f32
  sums an ICP assignment here ties, ROADMAP Queue 3's rule).
- Bucketed prefill and paged decode logits within 1e-4.
- One reference `Scheduler(spec=SpecConfig(k=3))` run of greedy and
  sampled requests (sharing and async admission at their defaults) gives
  the port's token streams.

The reference's compiles (its prune, its scheduler run, its jitted
functions) run on threads beside the port's work (XLA compiles outside the
GIL).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.core.types import HiNMConfig as JHiNMConfig
from repro.core.types import PackedHiNM as JPackedHiNM
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models import module as jnn
from repro.models import zoo as jzoo
from repro.train import pruning as jpruning
from repro_torch import serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.core import packing
from repro_torch.core.types import HiNMConfig, PackedHiNM
from repro_torch.kernels import ops
from repro_torch.models import moe, paging, zoo
from repro_torch.train import pruning
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_train_ref import reference_search_costs

NAME = "granite_moe_3b_a800m"
# d_ff = d_model: the expert matrices share the query projection's shape,
# so the reference compiles fewer search and matmul programs
RED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128, head_dim=16)
TOL = 1e-4
ITERS = (2, 2)
# a capacity factor low enough that the reference drops (token, slot)s
LOW_CF = 0.25
MAX_SEQ, PAGE, N_SLOTS = 64, 8, 3
N_PAGES = paging.N_RESERVED + 12
SCHED = dict(max_slots=2, max_seq=64, page=16, decode_chunk=4)
K = 3


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                               rtol=tol, atol=tol)


def _jroute(p, x, cfg, capacity_factor):
    """The reference's routing, step for step as `repro.models.moe.moe_apply`
    computes it: (topi, pos, keep) as numpy."""
    nt, e, k = x.shape[0] * x.shape[1], cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(jnn.linear(p["router"], x.reshape(nt, -1).astype(jnp.float32)), -1)
    _, topi = jax.lax.top_k(probs, k)
    cap = max(8, ((int(nt * k * capacity_factor / e) + 7) // 8) * 8)
    flat = jax.nn.one_hot(topi, e, dtype=jnp.int32).reshape(nt * k, e)
    pos = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1).reshape(nt, k)
    return np.asarray(topi), np.asarray(pos), np.asarray(pos < cap)


def _inputs():
    rng = np.random.default_rng(3)
    n_rows = np.array([9, 14], np.int32)
    toks = rng.integers(0, RED["vocab"], (2, 16)).astype(np.int32)
    for i, n in enumerate(n_rows):
        toks[i, n:] = 0
    n_bt = MAX_SEQ // PAGE
    free = list(rng.permutation(np.arange(paging.N_RESERVED, N_PAGES)))
    inserts = []
    for row, slot in ((0, 2), (1, 0)):
        pages = [int(free.pop()) for _ in range(3)]
        ids = np.full((n_bt,), paging.SCRATCH_PAGE, np.int32)
        bt_row = np.full((n_bt,), paging.SENTINEL_PAGE, np.int32)
        ids[:3] = bt_row[:3] = pages
        inserts.append((row, slot, ids, bt_row))
    return dict(x=rng.standard_normal((2, 16, RED["d_model"])).astype(np.float32),
                prefill=toks, n_rows=n_rows, inserts=inserts,
                decode=rng.integers(0, RED["vocab"], (3, N_SLOTS, 1)).astype(np.int32))


def _workload(mod, vocab):
    """Six requests over two slots, one arriving a step, prompts of 9-16
    tokens (one length bucket), 8 new each; every other one sampled
    (T 0.8, top-k 16)."""
    rng = np.random.default_rng(23)
    reqs = []
    for i in range(6):
        sp = mod.SamplingParams(max_new_tokens=8)
        if i % 2:
            sp.temperature, sp.top_k, sp.seed = 0.8, 16, 40 + i
        reqs.append(mod.Request(rid=i, prompt=rng.integers(1, vocab, (9 + i,))
                                .astype(np.int32), params=sp, arrival=i))
    return reqs


def _reference_model_runs(jcfg, dense, packed, x):
    """The reference's jitted MoE block (routing included) at both
    capacity factors, its aux loss, and the packed model's bucketed
    prefill, paged inserts and decode steps."""
    blk0 = jax.tree.map(lambda a: a[0], dense["blocks"]["moe"])
    xj = jnp.asarray(x["x"])
    out = {"moe": {cf: (jax.jit(jmoe.moe_apply, static_argnums=(2, 3))(blk0, xj, jcfg, cf),
                        _jroute(blk0, xj, jcfg, cf)) for cf in (1.25, LOW_CF)},
           "aux": jmoe.aux_load_balance_loss(blk0, xj, jcfg)}
    st = jzoo.make_cache(jcfg, 2, MAX_SEQ)
    out["last"], st = jax.jit(jzoo.prefill, static_argnums=1)(
        packed, jcfg, jnp.asarray(x["prefill"]), st, n_rows=jnp.asarray(x["n_rows"]))
    pool = jzoo.make_cache(jcfg, N_SLOTS, MAX_SEQ, page=PAGE, n_pages=N_PAGES)
    insert = jax.jit(jzoo.paged_insert, static_argnums=0)
    for row, slot, ids, bt_row in x["inserts"]:
        pool = insert(jcfg, pool, st, slot, row, jnp.asarray(ids), jnp.asarray(bt_row),
                      np.int32(3))
    decode = jax.jit(jzoo.decode_step, static_argnums=1)
    logits = []
    for tok in x["decode"]:
        lg, pool = decode(packed, jcfg, jnp.asarray(tok), pool)
        logits.append(lg)
    out["decode"] = np.stack(logits)
    return jax.tree.map(np.asarray, out)


def _reference_serve(jcfg, packed):
    sched = jserve.Scheduler(jcfg, packed, spec=jserve.SpecConfig(k=K), **SCHED)
    reqs = _workload(jserve, jcfg.vocab)
    sched.run(reqs)
    return reqs


@pytest.fixture(scope="module")
def setup():
    """Both configs, the seeded dense params tree (numpy) and the
    reference's packing of it; then, on threads, the reference's prune
    (gyro 2/2), scheduler run and jitted functions, beside the port's own
    prune and scheduler run."""
    jcfg, cfg = jload_arch(NAME).reduced(**RED), load_arch(NAME).reduced(**RED)
    dense = jax.tree.map(lambda t: t.numpy(), zoo.params_of(cfg, zoo.init(
        cfg, torch.Generator().manual_seed(0), "cpu")))
    jdense = jax.tree.map(jnp.asarray, dense)
    packed = jax.tree.map(np.asarray, jax.jit(jzoo.pack_params, static_argnums=0)(jcfg, jdense))
    x = _inputs()
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        jprune = ex.submit(lambda: jpruning.prune_model(
            jdense, jcfg, rng=np.random.default_rng(0), ocp_iters=ITERS[0],
            icp_iters=ITERS[1], workers=4))
        jserved = ex.submit(_reference_serve, jcfg, packed)
        jruns = ex.submit(_reference_model_runs, jcfg, jdense, packed, x)
        model = params_from_numpy(cfg, dense, "cpu")
        kw = dict(rng=np.random.default_rng(0), ocp_iters=ITERS[0], icp_iters=ITERS[1],
                  workers=2)
        pruned = pruning.prune_model(model, cfg, **kw)
        with pytest.MonkeyPatch.context() as mp:
            reference_search_costs(mp)
            kw["rng"] = np.random.default_rng(0)
            replay = pruning.prune_model(model, cfg, **kw)[1]
        sched = serve.Scheduler(cfg, params_from_numpy(cfg, packed, "cpu"),
                                spec=serve.SpecConfig(k=K), device="cpu", **SCHED)
        reqs = _workload(serve, cfg.vocab)
        sched.run(reqs)
        jp = jprune.result()
        return dict(jcfg=jcfg, cfg=cfg, dense=dense, packed=packed, x=x, model=model,
                    pruned=pruned, replay=replay, jpruned=(jax.tree.map(np.asarray, jp[1]), jp[3]),
                    served=(sched, reqs), jserved=jserved.result(), jruns=jruns.result())


@pytest.mark.parametrize("cf", [1.25, LOW_CF])
def test_moe_apply_and_routing_match(setup, cf):
    cfg, model = setup["cfg"], setup["model"]
    want, (topi, pos, keep) = setup["jruns"]["moe"][cf]
    p, x = model.blocks[0].moe, torch.from_numpy(setup["x"]["x"])
    _close(want, moe.moe_apply(p, x, cfg, cf))
    _, ttopi, tpos, tkeep, cap = moe.route(p, x, cfg, cf)
    np.testing.assert_array_equal(ttopi.numpy(), topi)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    assert cap == moe.capacity(x.shape[0] * x.shape[1], cfg, cf)
    # the default keeps every (token, slot) here; the low factor drops some
    assert keep.all() == (cf == 1.25)


def test_aux_load_balance_loss_matches(setup):
    cfg, model = setup["cfg"], setup["model"]
    got = moe.aux_load_balance_loss(model.blocks[0].moe, torch.from_numpy(setup["x"]["x"]), cfg)
    _close(setup["jruns"]["aux"], got, 1e-6)


def test_moe_row_bits_do_not_depend_on_the_call():
    """A token's MoE output, with no drop, is bitwise the same alone and
    among other rows (the fixed-order sums); so are the routing sums."""
    cfg = load_arch(NAME).reduced(**RED)
    p = moe.moe_init(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    x = torch.randn((16, 1, cfg.d_model), generator=torch.Generator().manual_seed(5))
    full = moe.moe_apply(p, x, cfg, capacity_factor=4.0)
    probs = moe.router_probs(p, x[:, 0])
    for n in (1, 4):
        for at in (0, n):
            assert torch.equal(moe.moe_apply(p, x[at: at + n], cfg, capacity_factor=4.0),
                               full[at: at + n])
            assert torch.equal(moe.router_probs(p, x[at: at + n, 0]), probs[at: at + n])
    assert torch.equal(moe._fixed_sum(torch.arange(12.0).reshape(2, 6)),
                       torch.tensor([15.0, 51.0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_k1_plain_versions_match_vmapped_pallas(dtype):
    """K1's plain versions over a stack of 3 experts (n_out 32, n_in 64,
    V 8, 5 rows each) against the reference's Pallas kernel in interpret
    mode under `jax.vmap` over the experts."""
    rng = np.random.default_rng(9)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    hc = HiNMConfig(v=8)
    w = torch.from_numpy(rng.normal(size=(3, 32, 64)).astype(np.float32)).to(tdt)
    x = torch.from_numpy(rng.normal(size=(3, 5, 64)).astype(np.float32)).to(tdt)
    p = packing.stack([packing.pack(we, hc) for we in w])
    jp = JPackedHiNM(jnp.asarray(p.vals.float().numpy()).astype(jdt),
                     jnp.asarray(p.vec_idx.numpy()), jnp.asarray(p.nm_idx.numpy()),
                     p.n_out, p.n_in, JHiNMConfig(hc.v, hc.n, hc.m, hc.vector_sparsity))
    want = jax.vmap(lambda pe, xe: jops.hinm_matmul(xe, pe, backend="interpret"))(
        jp, jnp.asarray(x.float().numpy()).astype(jdt))
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    for backend in ("auto", "torch", "oracle"):
        got = ops.hinm_matmul(x, p, backend)
        assert got.shape == (3, 5, 32) and got.dtype == tdt
        _close(np.asarray(want.astype(jnp.float32)), got.float(), tol)
    with pytest.raises(ValueError, match="expert stack"):
        ops.hinm_matmul(x[0], p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.hinm_matmul(x, p, "cuda")


def test_pack_and_unpack_of_expert_stacks_bit_equal_reference(setup):
    cfg, packed = setup["cfg"], setup["packed"]
    model = zoo.pack_params(cfg, params_from_numpy(cfg, setup["dense"], "cpu"))
    for i, blk in enumerate(model.blocks):
        for name in ("wg", "wu", "wd"):
            p, jp = getattr(blk.moe, name).w, packed["blocks"]["moe"][name]["w"]
            assert isinstance(p, PackedHiNM) and p.vals.dim() == 4
            assert (p.t, p.k, p.kn) == (jp.vals.shape[-3], jp.vec_idx.shape[-1], jp.vals.shape[-1])
            for f in ("vals", "vec_idx", "nm_idx"):
                np.testing.assert_array_equal(getattr(p, f).numpy(), getattr(jp, f)[i])
            assert p.packed_bytes() == sum(getattr(jp, f)[i].nbytes for f in (
                "vals", "vec_idx", "nm_idx"))
    dense = zoo.params_of(cfg, zoo.unpack_params(cfg, model))
    jdense = jax.tree.map(np.asarray, jax.jit(jzoo.unpack_params, static_argnums=0)(
        setup["jcfg"], jax.tree.map(jnp.asarray, packed)))
    for name in ("router", "wg", "wu", "wd"):
        np.testing.assert_array_equal(dense["blocks"]["moe"][name]["w"].numpy(),
                                      jdense["blocks"]["moe"][name]["w"])


def test_prune_model_masks_per_expert_match_reference(setup):
    cfg = setup["cfg"]
    permuted, masks, packed, rep = setup["pruned"]
    jmasks, jrep = setup["jpruned"]
    want = masks_from_numpy(cfg, jmasks, "cpu")
    for i, (got, ref) in enumerate(zip(setup["replay"], want)):
        assert set(got) == set(ref)
        for path, m in got.items():
            assert m.shape == ref[path].shape, path
            assert torch.equal(m, ref[path]), (i, path)
    assert [k for k, _ in rep.per_layer] == [k for k, _ in jrep.per_layer]
    _close([r for _, r in jrep.per_layer], [r for _, r in rep.per_layer], 1e-5)
    assert abs(rep.mean_retained - jrep.mean_retained) < 1e-5
    # the packed copy serves what the permuted one computes on its masks
    blk = packed.blocks[1].moe
    assert isinstance(blk.wg.w, PackedHiNM) and blk.wg.w.vals.shape[0] == cfg.n_experts
    for e in range(cfg.n_experts):
        np.testing.assert_array_equal(
            packing.unpack(blk.wd.w.expert(e)).T.numpy(),
            (permuted.blocks[1].moe.wd.w[e] * masks[1]["moe/wd"][e]).numpy())
    # the masks' tree and its per-block view round-trip
    params = zoo.params_of(cfg, permuted)
    tree = pruning.mask_tree(params, masks)
    assert tree["blocks"]["moe"]["wg"]["w"].shape == (cfg.n_layers, cfg.n_experts,
                                                      cfg.d_model, cfg.d_ff)
    assert tree["blocks"]["moe"]["router"]["w"] is None
    back = pruning.per_block(tree, list(masks[0]))
    assert all(torch.equal(back[i][k], masks[i][k]) for i in range(cfg.n_layers)
               for k in masks[i])


def test_bucketed_prefill_and_paged_decode_match(setup):
    cfg, x, ref = setup["cfg"], setup["x"], setup["jruns"]
    model = params_from_numpy(cfg, setup["packed"], "cpu")
    tst = zoo.make_cache(cfg, 2, MAX_SEQ, device="cpu")
    _close(ref["last"], zoo.prefill(model, cfg, torch.from_numpy(x["prefill"]), tst,
                                    n_rows=torch.from_numpy(x["n_rows"])))
    pool = zoo.make_cache(cfg, N_SLOTS, MAX_SEQ, page=PAGE, n_pages=N_PAGES, device="cpu")
    for row, slot, ids, bt_row in x["inserts"]:
        zoo.paged_insert(cfg, pool, tst, slot, row, torch.from_numpy(ids),
                         torch.from_numpy(bt_row), 3)
    for step, tok in enumerate(x["decode"]):
        _close(ref["decode"][step], zoo.decode_step(model, cfg, torch.from_numpy(tok), pool))


def test_scheduler_streams_equal_reference(setup):
    sched, reqs = setup["served"]
    jreqs = setup["jserved"]
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert [r.finish_reason for r in reqs] == [r.finish_reason for r in jreqs]
    assert any(r.params.temperature > 0 for r in reqs)
    assert sched.stats.verify_steps > 0
