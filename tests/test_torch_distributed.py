"""Port parity: the distributed and launch layer (`repro_torch.distributed`,
`launch`, `train.abstract`, `data.pipeline.make_batch_specs`, the sharded
steps of `train.steps`) against `repro.distributed`, `repro.launch`,
`repro.train`.

In this process: the sharding rules of all 12 configs at full width on
the (16, 16) and (2, 16, 16) production meshes (dense and packed trees,
path for path), the optimizer-state, batch and cache specs, the page
geometry, the abstract (meta) views and the cells' applicability and
microbatching, each equal to the reference's.  In one spawned gloo group
of 4 ranks (`tests/torch_dist_ranks.py`, started first, running beside
these): four decode steps through `shard_serve_step` on a (2, 2) mesh
(T-sharded K1, sequence-parallel attention) within 1e-5 of the
reference's unsharded `zoo.decode_step`; the sharded train step's first
loss and gradients within 1e-5 of the reference's and three AdamW losses
within 1e-4; each launch cell run at a reduced shape; `pipeline_apply`
over 4 stages within 1e-5 of the sequential chain.  The launch CLI runs
a few steps on 2 ranks under ``torchrun``.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import serve_conformance as sc
import torch_dist_ranks as R
from repro import compat
from repro.configs.base import ARCH_IDS, PAPER_IDS, SHAPES as JSHAPES
from repro.configs.base import load_arch as jload_arch
from repro.data.pipeline import make_batch_specs as jmake_batch_specs
from repro.distributed import sharding as jshd
from repro.launch import cells as jcells
from repro.models import paging as jpaging
from repro.models import zoo as jzoo
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import abstract as jabst
from repro.train import steps as jsteps
from repro_torch import tree as T
from repro_torch.configs.base import SHAPES, load_arch
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import paging, zoo
from repro_torch.optim import make_optimizer
from repro_torch.train import abstract as abst
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ARCH_IDS + PAPER_IDS
SERVE = sc._CASES["transformer"]["reduced"]
TRAIN = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16)
BATCH = 4
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The 4-rank group and the 2-rank launch run, started before any test
    of the module so that they run beside the in-process comparisons."""
    tmp = tmp_path_factory.mktemp("distributed")
    scfg = load_arch("qwen2_0_5b").reduced(**SERVE)
    model = zoo.init(scfg, torch.Generator().manual_seed(11), device="cpu")
    serve_tree = T.map(lambda t: jnp.asarray(t.numpy()), zoo.params_of(scfg, model))
    zoo.pack_params(scfg, model)
    tcfg = load_arch("qwen2_0_5b").reduced(**TRAIN)
    train_params = zoo.params_of(tcfg, zoo.init(tcfg, torch.Generator().manual_seed(0),
                                                 device="cpu"))
    prompts = np.random.default_rng(5).integers(0, scfg.vocab, (BATCH, 6)).astype(np.int64)
    rng = np.random.default_rng(0)
    pipeline = (rng.normal(size=(4, 16, 16)).astype(np.float32) * 0.3,
                rng.normal(size=(4, 16)).astype(np.float32) * 0.1,
                rng.normal(size=(8, 2, 16)).astype(np.float32))
    payload = dict(serve_reduced=SERVE, serve_model=model, prompts=prompts, batch=BATCH,
                   train_reduced=TRAIN, train_params=train_params, pipeline=pipeline)
    group = R.Group("distributed_job", 4, tmp, payload)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    launch = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.train", "--scale", "tiny", "--steps", "3",
         "--batch", "4", "--seq", "32", "--device", "cpu",
         "--checkpoint-dir", str(tmp / "ckpt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    handle = dict(group=group, launch=launch, serve_tree=serve_tree, prompts=prompts,
                  train_params=train_params, pipeline=pipeline, model=model)
    yield handle
    if launch.poll() is None:
        launch.kill()


@pytest.fixture(scope="module")
def ranks(started):
    return started["group"].results()


# ---------------------------------------------------------------------------
# the rules, in this process
# ---------------------------------------------------------------------------

JMESHES = (compat.abstract_mesh((16, 16), ("data", "model")),
           compat.abstract_mesh((2, 16, 16), ("pod", "data", "model")))
MESHES = (make_production_mesh(), make_production_mesh(multi_pod=True))


def _jflat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(jshd._key_str(k) for k in path): tuple(s) for path, s in flat}


def _flat(specs):
    return {k: tuple(v) for k, v in shd.flatten_with_path(specs).items()}


def _jshapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(jshd._key_str(k) for k in path): (tuple(x.shape), str(np.dtype(x.dtype)))
            for path, x in flat}


def _shapes(tree):
    return {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for k, x in shd.flatten_with_path(tree).items()}


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference cfg, port cfg, reference params shape, port params shape)."""
    jcfg, cfg = jload_arch(arch), load_arch(arch)
    return (jcfg, cfg, jax.eval_shape(lambda: jzoo.init(jax.random.PRNGKey(0), jcfg)),
            abst.params_shape(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    """`param_specs` of every config at full width, on both production
    meshes, dense and packed, equal the reference's path for path; every
    resolved axis divides its dim."""
    jcfg, cfg, jp, p = _trees(arch)
    for jm, m in zip(JMESHES, MESHES):
        for jt, t in ((jp, p), (jabst.abstract_packed(jp, jcfg), abst.abstract_packed(p, cfg))):
            ours = _flat(shd.param_specs(t, m, cfg))
            assert ours == _jflat(jshd.param_specs(jt, jm, jcfg))
            shapes = _shapes(t)
            for path, spec in ours.items():
                for dim, ax in zip(shapes[path][0], spec):
                    if ax is not None:
                        n = int(np.prod([m.shape[a] for a in (ax if isinstance(ax, tuple)
                                                              else (ax,))]))
                        assert dim % n == 0, (path, spec)


@pytest.mark.parametrize("arch", ["qwen2_5_14b", "grok_1_314b"])
def test_opt_state_specs_equal_reference(arch):
    """AdamW's and the config's own optimizer's state specs equal the
    reference's (grok-1's is Adafactor: factored moments)."""
    jcfg, cfg, jp, p = _trees(arch)
    for name in sorted({"adamw", cfg.optimizer}):
        jo = jax.eval_shape(jmake_optimizer(name).init, jp)
        o = make_optimizer(name).init(p)
        js = jshd.opt_state_specs(jo, jshd.param_specs(jp, JMESHES[0], jcfg))
        ps = shd.opt_state_specs(o, shd.param_specs(p, MESHES[0], cfg))
        assert _flat(ps) == _jflat(js)
        assert set(_flat(ps)) == set(_shapes(o))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_views_equal_reference(arch):
    """`abstract_masks`, `abstract_packed` and `make_batch_specs` give the
    reference's shapes and dtypes, path for path (meta tensors)."""
    jcfg, cfg, jp, p = _trees(arch)
    assert _shapes(abst.abstract_masks(p, cfg)) == _jshapes(jabst.abstract_masks(jp, jcfg))
    packed = abst.abstract_packed(p, cfg)
    assert _shapes(packed) == _jshapes(jabst.abstract_packed(jp, jcfg))
    assert all(x.device.type == "meta" for x in shd.flatten_with_path(packed).values())
    for seq, batch in ((4096, 256), (2048, 16)):
        args = (seq, batch, cfg.vocab, cfg.frontend, cfg.d_model, cfg.frontend_tokens)
        assert _shapes(make_batch_specs(*args)) == _jshapes(jmake_batch_specs(*args))


def test_cells_applicability_equal_reference():
    """Each cell's `shape_applicable` and `pick_microbatches` equal the
    reference's, every config x shape, on both production meshes."""
    assert SHAPES == JSHAPES
    for arch in ARCHS:
        jcfg, cfg = jload_arch(arch), load_arch(arch)
        for shape, (seq, batch, _) in SHAPES.items():
            assert cells.shape_applicable(cfg, shape) == jcells.shape_applicable(jcfg, shape)
            for jm, m in zip(JMESHES, MESHES):
                assert cells.pick_microbatches(cfg, seq, batch, m) == \
                    jcells.pick_microbatches(jcfg, seq, batch, jm), (arch, shape)


def test_batch_and_cache_specs():
    """`tests/test_distributed.py::test_batch_and_cache_specs` on the port,
    and every spec equal to the reference's."""
    mesh, jmesh = MESHES[1], JMESHES[1]
    cfg, jcfg = load_arch("qwen2_5_14b"), jload_arch("qwen2_5_14b")
    batch = {"tokens": torch.empty((256, 128), dtype=torch.int32, device="meta"),
             "odd": torch.empty((3, 4), device="meta")}
    bs = shd.batch_specs(batch, mesh)
    assert tuple(bs["tokens"])[0] == ("pod", "data")
    assert tuple(bs["odd"]) == (None, None)
    jbatch = {"tokens": jax.ShapeDtypeStruct((256, 128), jnp.int32),
              "odd": jax.ShapeDtypeStruct((3, 4), jnp.float32)}
    assert _flat(bs) == _jflat(jshd.batch_specs(jbatch, jmesh))
    cache = zoo.make_cache(cfg, 128, 4096, device="meta")
    cs = shd.cache_specs(cache, mesh, cfg)
    kspec = tuple(cs["k"])
    assert kspec[1] == ("pod", "data") and "model" in (kspec[2], kspec[3])
    jcache = jax.eval_shape(lambda: jzoo.make_cache(jcfg, 128, 4096))
    assert _flat(cs) == _jflat(jshd.cache_specs(jcache, jmesh, jcfg))
    assert _flat(shd.cache_specs(cache, mesh)) == _jflat(jshd.cache_specs(jcache, jmesh))


def test_cache_specs_paged_layout():
    """`tests/test_distributed.py::test_cache_specs_paged_layout` on the
    port: pool leaves shard their page axis and per-slot leaves their slot
    axis on a data-only mesh; a page count that does not divide replicates
    the pools; the xlstm state tree resolves; hybrid and encdec pools as
    the reference's."""
    mesh = shd.abstract_mesh((4,), ("data",))
    jmesh = compat.abstract_mesh((4,), ("data",))
    red = sc._CASES["transformer"]["reduced"]
    cfg, jcfg = load_arch("qwen2_0_5b").reduced(**red), jload_arch("qwen2_0_5b").reduced(**red)
    geom = paging.shard_geometry(10, 4)
    assert geom["n_pages"] % 4 == 0 and geom["n_pages"] >= 12
    cache = zoo.make_cache(cfg, 4, 64, page=16, n_pages=geom["n_pages"], device="meta")
    cs = shd.cache_specs(cache, mesh, cfg)
    for pool in ("k", "v", "kpos"):
        assert tuple(cs[pool])[1] == "data" and tuple(cs[pool])[2] is None, pool
    for slot in ("bt", "alloc", "pos"):
        assert tuple(cs[slot])[1] == "data", slot
    odd = shd.cache_specs(zoo.make_cache(cfg, 4, 64, page=16, n_pages=13, device="meta"),
                          mesh, cfg)
    assert tuple(odd["k"])[1] is None and tuple(odd["bt"])[1] == "data"
    for fam in ("hybrid", "encdec", "transformer", "ssm"):
        c = sc._CASES[fam]
        cfg = load_arch(c["arch"]).reduced(**c["reduced"])
        jcfg = jload_arch(c["arch"]).reduced(**c["reduced"])
        kw = dict(c.get("cache_kw") or {})
        if fam != "ssm":
            g = zoo.page_geometry(cfg, 64, c["page"])
            kw.update(page=g["page"], n_pages=16)
        ours = shd.cache_specs(zoo.make_cache(cfg, 4, 64, device="meta", **kw), mesh, cfg)
        ref = jshd.cache_specs(jax.eval_shape(lambda: jzoo.make_cache(jcfg, 4, 64, **kw)),
                               jmesh, jcfg)
        assert _flat(ours) == _jflat(ref), fam
    xs = _flat(ours)
    assert all(spec[1] == "data" for spec in xs.values())


def test_shard_geometry_equals_reference():
    for n_alloc in (1, 7, 10, 13, 64, 1000):
        for n_shards in (1, 2, 4, 16):
            assert paging.shard_geometry(n_alloc, n_shards) == \
                jpaging.shard_geometry(n_alloc, n_shards)


def test_production_mesh_and_placements():
    """The production meshes' axes and sizes; a spec's placements."""
    m1, m2 = MESHES
    assert m1.shape == {"data": 16, "model": 16} and m1.size == 256
    assert m2.shape == {"pod": 2, "data": 16, "model": 16} and m2.size == 512
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:  # the two attributes `mesh_view` reads of a DeviceMesh
        mesh_dim_names = ("data", "model")

        @staticmethod
        def size(i):
            return (2, 2)[i]

    assert shd.to_placements(shd.P(None, "model", "data"), _Mesh) == [Shard(2), Shard(1)]
    assert shd.to_placements(shd.P(), _Mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="order"):
        shd.to_placements(shd.P(("model", "data")), _Mesh)


# ---------------------------------------------------------------------------
# the 4-rank group's runs against the reference's unsharded ones
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_decode(started):
    """The reference's unsharded greedy tokens and logits of four decode
    steps after the prompts' prefill, on the serve model's weights."""
    jcfg = jload_arch("qwen2_0_5b").reduced(**SERVE)
    scfg = load_arch("qwen2_0_5b").reduced(**SERVE)
    params = R.reference_packed_tree(scfg, started["model"], started["serve_tree"])
    cache = jzoo.make_cache(jcfg, BATCH, R.MAX_SEQ)
    last, cache = jax.jit(lambda p, t, c: jzoo.prefill(p, jcfg, t, c))(
        params, jnp.asarray(started["prompts"], jnp.int32), cache)
    tok = jnp.argmax(jzoo.logits_fn(params, jcfg, last)[:, :jcfg.vocab], -1)[:, None]
    dec = jax.jit(lambda p, t, c: jzoo.decode_step(p, jcfg, t, c))
    toks, logits = [np.asarray(tok)[:, 0]], []
    for _ in range(4):
        lg, cache = dec(params, tok.astype(jnp.int32), cache)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, :jcfg.vocab], -1)[:, None]
        toks.append(np.asarray(tok)[:, 0])
    return toks, logits


@pytest.mark.parametrize("run", list(R.SERVE_KNOBS))
def test_sharded_decode_matches_reference(ranks, reference_decode, run):
    """Four decode steps through `shard_serve_step` on (2, 2), at each
    distributed knob's default ("default") and its other values: logits
    within 1e-5 of the reference's unsharded decode on the same weights,
    greedy tokens equal.  The default runs the T-sharded K1 (7
    projections a layer, each rank its tiles) and the sequence-parallel
    attention over a sequence-sharded stripe; "gather" turns both off
    (tiles and stripe gathered whole); "heads" shards the stripe's KV heads
    (gathered for the step, K1 still T-sharded); "tiles_both" and
    "tiles_model" shard the tiles over 'data' too, so each packed weight
    is gathered on use, and "tiles_both" shards the embedding's features."""
    scfg = load_arch("qwen2_0_5b").reduced(**SERVE)
    ref_toks, ref_logits = reference_decode
    out = ranks[0]["serve", run]
    for i in range(5):
        assert np.array_equal(out["tokens"][i][:, 0], ref_toks[i]), i
    for i in range(4):
        err = np.abs(out["logits"][i] - ref_logits[i]).max()
        assert err <= TOL, (i, err)
    for other in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(other["serve", run]["logits"],
                                                         out["logits"]))
    n_proj = 7 * scfg.n_layers * 4
    seq = {"seq_parallel_decode": scfg.n_layers * 4}
    L, B, S, KV, hd = scfg.n_layers, BATCH, R.MAX_SEQ, scfg.n_kv_heads, scfg.head_dim
    want = {
        "default": ({"hinm_spmm_shard_map": n_proj} | seq, "TileShard", (L, B // 2, S // 2, KV, hd)),
        "gather": ({}, "TileShard", (L, B // 2, S // 2, KV, hd)),
        "heads": ({"hinm_spmm_shard_map": n_proj}, "TileShard", (L, B // 2, S, KV // 2, hd)),
        "tiles_both": (seq, "PackedHiNM", (L, B // 2, S // 2, KV, hd)),
        "tiles_model": (seq, "PackedHiNM", (L, B // 2, S // 2, KV, hd)),
    }[run]
    assert (out["calls"], out["tile_shard"], out["k_local"]) == want
    assert out["seq_sharded"] == (run != "heads")
    vocab, d = scfg.vocab_padded, scfg.d_model
    assert out["table_local"] == ((vocab, d // 2) if run == "tiles_both" else (vocab // 2, d // 2))


@pytest.mark.parametrize("kn", [dict(embed_feature_shard=True), dict(packed_t_axes="both"),
                                dict(packed_t_axes="model")], ids=str)
def test_param_specs_knobs_equal_reference(kn):
    """The distributed knobs `param_specs` reads, at their other values:
    the port's specs equal the reference's under the same knobs, dense and
    packed, on both production meshes, for a dense and an expert config."""
    from repro import perf_knobs as jknobs
    from repro_torch import perf_knobs

    for arch in ("qwen2_5_14b", "grok_1_314b"):
        jcfg, cfg, jp, p = _trees(arch)
        with perf_knobs.knobs(**kn), jknobs.knobs(**kn):
            for jm, m in zip(JMESHES, MESHES):
                for jt, t in ((jp, p), (jabst.abstract_packed(jp, jcfg),
                                        abst.abstract_packed(p, cfg))):
                    assert _flat(shd.param_specs(t, m, cfg)) == \
                        _jflat(jshd.param_specs(jt, jm, jcfg)), arch


@pytest.mark.parametrize("kn", [dict(decode_seq_shard=False), dict(paged_attn_sharded=True)],
                         ids=str)
def test_cache_specs_knobs_equal_reference(kn):
    """The distributed knobs `cache_specs` reads, at their other values:
    the stripe and paged caches' specs equal the reference's under the
    same knobs, on the (2, 16, 16) mesh and a data-only mesh of 4."""
    from repro import perf_knobs as jknobs
    from repro_torch import perf_knobs

    cfg, jcfg = load_arch("qwen2_5_14b"), jload_arch("qwen2_5_14b")
    meshes = ((MESHES[1], JMESHES[1]), (shd.abstract_mesh((4,), ("data",)),
                                        compat.abstract_mesh((4,), ("data",))))
    with perf_knobs.knobs(**kn), jknobs.knobs(**kn):
        for m, jm in meshes:
            for kw in ({}, dict(page=16, n_pages=64)):
                cache = zoo.make_cache(cfg, 128, 4096, device="meta", **kw)
                jcache = jax.eval_shape(lambda: jzoo.make_cache(jcfg, 128, 4096, **kw))
                assert _flat(shd.cache_specs(cache, m, cfg)) == \
                    _jflat(jshd.cache_specs(jcache, jm, jcfg)), kw


def test_sharded_train_step_matches_reference(ranks, started):
    """`shard_train_step` on (2, 2) (batch 8, 4 rows a dp rank): the first
    loss and every gradient within 1e-5 of the reference's unsharded
    step's; three AdamW losses within 1e-4 of the reference's, falling."""
    from repro.data.pipeline import SyntheticLMData

    jcfg = jload_arch("qwen2_0_5b").reduced(**TRAIN)
    params = T.map(lambda t: jnp.asarray(t.numpy()), started["train_params"])
    batch = {k: jnp.asarray(v) for k, v in SyntheticLMData(jcfg.vocab, 32, 8, seed=0)
             .batch(0).items()}

    def loss_fn(p):
        x = jzoo.forward(p, jcfg, batch["tokens"])
        return jsteps.chunked_xent(p, jcfg, x, batch["labels"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    out = ranks[0]["train"]
    assert out["local_rows"] == 4
    assert abs(out["loss"] - float(loss)) <= TOL
    ref = {k: np.asarray(v) for k, v in shd.flatten_with_path(grads).items()}
    assert set(out["grads"]) == set(ref)
    for path, g in out["grads"].items():
        assert np.abs(g - ref[path]).max() <= TOL, path
    step_fn, opt = jsteps.make_train_step(jcfg, None)
    step = jax.jit(step_fn)
    opt_state, masks = opt.init(params), jax.tree.map(lambda x: None, params)
    losses = []
    for i in range(3):
        params, opt_state, metrics, _ = step(params, opt_state, masks, batch, i, None)
        losses.append(float(metrics["loss"]))
    assert np.abs(np.array(out["losses"]) - np.array(losses)).max() <= 1e-4
    assert out["losses"][2] < out["losses"][0]


def test_pipeline_matches_sequential(ranks, started):
    """`pipeline_apply` over 4 stages: within 1e-5 of the sequential chain
    (`tests/test_pipeline.py`'s inputs), the same on every rank."""
    ws, bs, x = started["pipeline"]
    ref = x
    for s in range(4):
        ref = np.tanh(ref @ ws[s] + bs[s])
    for r in ranks:
        assert np.abs(r["pipeline"] - ref).max() < 1e-5


def test_cells_run_on_mesh(ranks):
    """The train, prefill and decode cells built for (2, 2) and run at a
    reduced shape (seq 32, batch 4): finite results of the right shape."""
    cfg = load_arch("qwen2_0_5b").reduced(**TRAIN)
    runs = ranks[0]["cells"]
    assert runs["train_4k"][0] == "train" and np.isfinite(runs["train_4k"][1]).all()
    for shape, kind in (("prefill_32k", "prefill"), ("decode_32k", "decode")):
        k, logits = runs[shape]
        assert k == kind and logits.shape == (4, cfg.vocab_padded)
        assert np.isfinite(logits).all()


def test_launch_train_two_ranks(started):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --device
    cpu``: three steps on a (2, 1) mesh (FSDP over "data"), both ranks to
    the end."""
    launch = started["launch"]
    out, _ = launch.communicate(timeout=240)
    assert launch.returncode == 0, out
    assert out.count("done at step 3") == 2, out
