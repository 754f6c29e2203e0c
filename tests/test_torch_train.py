"""Port parity: the training path (`repro_torch.data`, `optim`, `checkpoint`,
`train.steps`, `train.loop`) against `repro` on the same numpy inputs, on
the CPU, at `tests/test_train.py`'s reduced qwen2-0.5b (2 layers, d 64,
heads 4/2, d_ff 128, vocab 128, hd 16, f32).

- Batches are bit-equal; the schedule, clipping, AdamW, Adafactor (a 1-D
  leaf, a layer-stacked 2-D norm scale and a stacked 3-D weight, the
  factored branch) and the top-k compressor agree within 1e-6 relative.
- `chunked_xent` and its gradients agree with `jax.value_and_grad` of the
  reference's loss (two chunks, with and without masks): the loss within
  1e-5, each gradient within 1e-4 of its leaf's max.
- Five steps of the reference's jitted `make_train_step` against the
  port's (no masks; the reference `prune_model`'s masks; top-k compression
  at 5%): losses within 1e-5, params within 1e-4 relative to each leaf's
  max outside the gradients' noise floor (`_free`); two microbatches equal
  one in the port.
- The loop's retry, restore-and-skip and resume; checkpoints cross between
  the packages in both directions, bf16 leaves bit for bit.
- The Fisher diagonal through the port's autograd agrees with the
  reference's within 1e-5 relative; second-order pruning on it gives the
  reference's masks when the port's search is replayed on the
  reference's cost helpers (ROADMAP Queue 3's OCP tie otherwise).
"""
import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import restore as jrestore
from repro.core import saliency as jsal
from repro.data.pipeline import SyntheticLMData as JSyntheticLMData
from repro.launch.mesh import make_host_mesh
from repro.models import zoo as jzoo
from repro.optim import compression as jcomp
from repro.train import pruning as jpruning
from repro.train import steps as jsteps
from repro_torch import optim, tree as T
from repro_torch.checkpoint import CheckpointManager, restore, save
from repro_torch.configs.base import load_arch
from repro_torch.core import saliency
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import zoo
from repro_torch.optim import compression
from repro_torch.train import loop, pruning, steps
from torch_train_ref import (ITERS, PATHS, REF_WORKERS, SIZES, inputs, masks_differ, ones_masks,
                             port_masks, port_model, port_params, reference,
                             reference_search_costs, tbatch)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = (1e-2, 5, 100)      # cosine_schedule(base, warmup, total), as tests/test_train.py


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close_leaf(got, want, rel, what="", free=None):
    """Within rel of max|want|; `free` marks elements left unchecked."""
    got, want = _np(got).astype(np.float64), np.asarray(_np(want), np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    if free is not None:
        got, want = got[~free], want[~free]
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)


def _close_tree(got, want, rel, free=None):
    """Leaf for leaf, in `jax.tree` order (names checked), each within rel
    of its max; `free` maps a leaf name to elements left unchecked."""
    g, w = T.leaves_with_names(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(g) == len(w)
    for (name, a), (path, b) in zip(g, w):
        assert name == "/".join(str(k) for k in path)
        _close_leaf(a, b, rel, name, (free or {}).get(name))


def _warm_port():
    """The port's first remat'd step, on weights of its own."""
    cfg = load_arch("qwen2_0_5b").reduced(**SIZES)
    params = zoo.params_of(cfg, zoo.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    steps.value_and_grad(params, cfg, None, {k: torch.zeros((2, 8), dtype=torch.int64)
                                             for k in ("tokens", "labels")})


@pytest.fixture(scope="module")
def setup():
    """The shared reference results (`torch_train_ref.reference`).  The
    reference's other work this module needs (its jitted loss gradient,
    the Fisher diagonal and the second-order prune on it, its two train
    steps, its forward on bf16 blocks) and the port's first remat'd
    step (whose `torch.utils.checkpoint` imports torch._dynamo) run on
    threads meanwhile: XLA compiles with the GIL released."""
    with ThreadPoolExecutor(5) as ex:
        futs = [ex.submit(_warm_port)]
        inputs(), ones_masks()
        futs += [ex.submit(_ref_second_order), ex.submit(_warm_step, 0.0),
                 ex.submit(_warm_step, 0.05), ex.submit(_ref_bf16)]
        r = reference()
        for f in futs:
            f.result()
    return r


@pytest.fixture(scope="module", autouse=True)
def _two_loss_chunks():
    """XENT_CHUNK 16 on both sides for this module: the 32-token batches'
    loss then runs over two chunks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "XENT_CHUNK", 16)
        mp.setattr(steps, "XENT_CHUNK", 16)
        yield


# ---------------------------------------------------------------------------
# data, optimizers, compression
# ---------------------------------------------------------------------------


def test_synthetic_data_bit_equal():
    want, got = JSyntheticLMData(512, 16, 8, seed=3), SyntheticLMData(512, 16, 8, seed=3,
                                                                      device="cpu")
    for step in range(4):
        w, g = want.batch(step), got.batch(step)
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int64 and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    w, g = want.batch(2, start=3, count=4), got.batch(2, start=3, count=4)
    np.testing.assert_array_equal(g["tokens"].numpy(), w["tokens"])
    for w, g, _ in zip(want.iterator(5), got.iterator(5), range(2)):
        np.testing.assert_array_equal(g["labels"].numpy(), w["labels"])
    big = SyntheticLMData(151936, 8, 2, device="cpu")     # the table cap
    assert big._v == 4096 and int(big.batch(0)["tokens"].max()) < 4096


def _opt_trees():
    rng = np.random.default_rng(0)
    shapes = {"bias": (7,), "scale": (3, 16), "w": (3, 16, 24)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    gs = [{k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in shapes.items()}
          for _ in range(3)]
    return p, gs


def test_schedule_and_clip_match():
    # the reference jitted, as its train step calls it
    want, got = jax.jit(joptim.cosine_schedule(*LR)), optim.cosine_schedule(*LR)
    for step in (0, 1, 4, 5, 6, 50, 99, 100, 150):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    p, gs = _opt_trees()
    for scale in (0.01, 100.0):
        g = {k: v * scale for k, v in gs[0].items()}
        jc, jn = jax.jit(joptim.clip_by_global_norm, static_argnums=1)(
            jax.tree.map(jnp.asarray, g), 1.0)
        c, n = optim.clip_by_global_norm(T.map(torch.from_numpy, g), 1.0)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        _close_tree(c, jc, 1e-6)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match(name):
    p, gs = _opt_trees()
    jopt, opt = joptim.make_optimizer(name), optim.make_optimizer(name)
    jupdate = jax.jit(jopt.update)      # as the reference's train step runs it
    jp, tp = jax.tree.map(jnp.asarray, p), T.map(torch.from_numpy, p)
    js, ts = jopt.init(jp), opt.init(tp)
    if name == "adafactor":   # the factored branch for the 2-D and 3-D leaves
        assert set(ts["v"]["scale"]) == {"vr", "vc"} and set(ts["v"]["bias"]) == {"v"}
    for i, g in enumerate(gs):
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp, 1e-2 * (i + 1))
        tp, ts = opt.update(T.map(torch.from_numpy, g), ts, tp, 1e-2 * (i + 1))
    _close_tree(tp, jp, 1e-6)
    _close_tree(ts, js, 1e-6)
    assert int(ts["count"]) == 3 and ts["count"].dtype == torch.int32


def test_ef_topk_compression_matches():
    _, gs = _opt_trees()
    jerr = jcomp.ef_topk_init(jax.tree.map(jnp.asarray, gs[0]))
    err = compression.ef_topk_init(T.map(torch.from_numpy, gs[0]))
    for g in gs[:2]:
        jsent, jerr = jax.jit(jcomp.ef_topk_compress, static_argnums=2)(
            jax.tree.map(jnp.asarray, g), jerr, 0.1)
        sent, err = compression.ef_topk_compress(T.map(torch.from_numpy, g), err, 0.1)
        _close_tree(sent, jsent, 1e-6)
        _close_tree(err, jerr, 1e-6)
        for a, b in zip(T.leaves(sent), jax.tree.leaves(jsent)):
            np.testing.assert_array_equal(a.numpy() != 0, np.asarray(b) != 0)


# ---------------------------------------------------------------------------
# loss, gradients, the train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_grad():
    """The reference's loss and its gradients, jitted."""
    jcfg = inputs().jcfg

    def loss_fn(params, masks, batch):
        p = jpruning.apply_masks(params, masks)
        x = jzoo.forward(p, jcfg, batch["tokens"])
        return jsteps.chunked_xent(p, jcfg, x, batch["labels"])

    return jax.jit(jax.value_and_grad(loss_fn))


@functools.lru_cache(maxsize=None)
def _ref_step(compress_kfrac):
    fn, _ = jsteps.make_train_step(inputs().jcfg, make_host_mesh(),
                                   lr_fn=joptim.cosine_schedule(*LR),
                                   compress_kfrac=compress_kfrac)
    return jax.jit(fn)


def _warm_step(kfrac):
    """One call of the reference's train step, which compiles it."""
    r = inputs()
    jp = jax.tree.map(jnp.asarray, r.params)
    _ref_step(kfrac)(jp, joptim.make_optimizer("adamw").init(jp), ones_masks(),
                     {k: jnp.asarray(v) for k, v in r.batches[0].items()}, 0,
                     jcomp.ef_topk_init(jp) if kfrac else None)


SECOND_ORDER = dict(saliency_kind="second_order", ocp_iters=ITERS[0], icp_iters=ITERS[1])


@functools.lru_cache(maxsize=None)
def _ref_second_order():
    """The reference's diagonal Fisher over three batches, and its
    `prune_model(saliency_kind="second_order")` on it: (Fisher, masks,
    report), as numpy."""
    r, ones = inputs(), ones_masks()
    jf = jax.tree.map(np.asarray, jsal.fisher_diag(
        lambda b: _ref_grad()(r.params, ones, b)[1], r.batches[:3]))
    _, jmasks, _, jrep = jpruning.prune_model(r.params, r.jcfg, fisher=jf,
                                              workers=REF_WORKERS, **SECOND_ORDER)
    return jf, jax.tree.map(np.asarray, jmasks), jrep


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_and_grads_match(setup, masked):
    r, b = setup, setup.batches[0]
    want_loss, want = _ref_grad()(r.params, r.vmasks if masked else ones_masks(), b)
    params = port_params(r)
    masks = port_masks(r, params) if masked else None
    loss, grads = steps.value_and_grad(params, r.cfg, masks, tbatch(b))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _close_tree(grads, want, 1e-4)
    if masked:   # a masked coordinate gets no gradient
        g, m = grads["blocks"]["mlp"]["wd"]["w"], masks["blocks"]["mlp"]["wd"]["w"]
        assert float(g[~m].abs().max()) == 0 and float(g[m].abs().max()) > 0


def _free(grads, floor=1e-3) -> dict:
    """The elements no comparison of trained params can hold: those whose
    first gradient is nonzero but under `floor` x its leaf's max|g| (sums
    that cancel to near zero, like a k-bias coordinate whose RoPE
    frequency barely turns over 32 positions; ~1% of the elements here).
    Another summation order changes such a gradient by percents, and
    AdamW, which divides by the gradient's own scale, turns that into
    another step; in the params and their moments."""
    out = {}
    for name, g in T.leaves_with_names(grads):
        m = ((g != 0) & (g.abs() < floor * g.abs().max())).numpy()
        out.update({f"{pre}{name}": m for pre in ("", "['mu']/", "['nu']/")})
    return out


@pytest.mark.parametrize("case", ["dense", "masked", "compressed"])
def test_train_step_matches_reference(setup, case):
    r = setup
    kfrac = 0.05 if case == "compressed" else 0.0
    jstep = _ref_step(kfrac)
    step, opt = steps.make_train_step(r.cfg, lr_fn=optim.cosine_schedule(*LR),
                                      compress_kfrac=kfrac)
    jp = jax.tree.map(jnp.asarray, r.params)
    jm = ones_masks() if case == "dense" else r.vmasks
    jo, je = joptim.make_optimizer("adamw").init(jp), None
    tp = port_params(r)
    tm = None if case == "dense" else port_masks(r, tp)
    to, te = opt.init(tp), None
    if kfrac:
        je, te = jcomp.ef_topk_init(jp), compression.ef_topk_init(tp)
    free = _free(steps.value_and_grad(tp, r.cfg, tm, tbatch(r.batches[0]))[1])
    for i, b in enumerate(r.batches):
        jp, jo, jmet, je = jstep(jp, jo, jm, {k: jnp.asarray(v) for k, v in b.items()}, i, je)
        tp, to, met, te = step(tp, to, tm, tbatch(b), i, te)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-4)
    _close_tree(tp, jp, 1e-4, free)
    _close_tree(to, jo, 1e-4, free)
    if tm is not None:
        w, m = tp["blocks"]["attn"]["wq"]["w"], tm["blocks"]["attn"]["wq"]["w"]
        assert float(w[~m].abs().max()) == 0
    if kfrac:
        _close_tree(te, je, 1e-4, free)


def test_microbatches_equal_one_batch(setup):
    r = setup
    tp, b = port_params(r), tbatch(r.batches[0])
    outs = []
    for mb in (1, 2):
        step, opt = steps.make_train_step(r.cfg, lr_fn=optim.cosine_schedule(*LR),
                                          microbatches=mb)
        outs.append(step(tp, opt.init(tp), None, b, 3))
    (p1, _, m1, _), (p2, _, m2, _) = outs
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    free = _free(steps.value_and_grad(tp, r.cfg, None, b)[1])
    for (name, a), c in zip(T.leaves_with_names(p2), T.leaves(p1)):
        _close_leaf(a, c, 1e-4, name, free.get(name))


@pytest.fixture(scope="module")
def fisher(setup):
    """The diagonal Fisher over three batches: the reference's and the
    port's (through `steps.value_and_grad`)."""
    r = setup
    params = port_params(r)
    got = saliency.fisher_diag(
        lambda b: steps.value_and_grad(params, r.cfg, None, tbatch(b))[1], r.batches[:3])
    return _ref_second_order()[0], got


def test_fisher_diag_matches(fisher):
    want, got = fisher
    _close_tree(got, want, 1e-5)


def test_second_order_prune_model_matches(setup, fisher):
    """`prune_model(saliency_kind="second_order")` on the same Fisher
    diagonal (the reference's).  Projections searched on their own w^2 F
    (attention) get the reference's masks.  The tied SwiGLU group may part:
    wg's OCP runs on [w^2 F | |wu|], whose cost the tied partner's
    magnitudes (~1e4 x larger) set, so its accept test compares candidates
    within an f32 ulp of the ~500 total, which the two frameworks' sums
    break apart, and the rest of the group's search (wu, and wd, whose
    input order follows the group's rows) goes on from another point
    (ROADMAP Queue 3): mean retained within 1e-3 relative (6.7e-4 here).
    The port's search replayed on the reference's cost helpers gives the
    reference's masks everywhere and its retained saliency within 1e-5:
    the engine's Fisher weighting, its tied concatenation and wd's own
    search are the reference's, and only the f32 costs part them."""
    r, (jf, _) = setup, fisher
    _, jmasks, jrep = _ref_second_order()
    fblocks = pruning.per_block(T.map(lambda a: torch.from_numpy(np.array(a)), jf), PATHS)

    def port(**over):
        return pruning.prune_model(port_model(r), r.cfg, fisher=fblocks, workers=1,
                                   **{**SECOND_ORDER, **over})

    _, masks, _, rep = port()
    differ = masks_differ(masks, jmasks)
    assert {path.split("/")[0] for _, path in differ} <= {"mlp"}
    assert [t for t, _ in rep.per_layer] == [t for t, _ in jrep.per_layer]
    for (tag, got), (_, want) in zip(rep.per_layer, jrep.per_layer):
        if "/attn/" in tag:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=tag)
    # the parted group's other search path: 6.7e-4 lower on average here
    np.testing.assert_allclose(rep.mean_retained, jrep.mean_retained, rtol=1e-3)
    for layer in masks:
        for path in ("mlp/wg", "mlp/wu", "mlp/wd"):
            assert float(layer[path].float().mean()) == 0.25
    with pytest.MonkeyPatch.context() as mp:
        reference_search_costs(mp)
        _, replay, _, rrep = port()
    assert not masks_differ(replay, jmasks)
    for (tag, got), (_, want) in zip(rrep.per_layer, jrep.per_layer):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=tag)
    # the Fisher weighting moved the masks off magnitude pruning's
    assert masks_differ(port(saliency_kind="magnitude")[1], jmasks)


# ---------------------------------------------------------------------------
# the loop and checkpoints
# ---------------------------------------------------------------------------


def test_loop_checkpoint_resume_and_failures(setup, tmp_path):
    r = setup
    step, opt = steps.make_train_step(r.cfg, lr_fn=optim.cosine_schedule(*LR))
    params = port_params(r)
    data = SyntheticLMData(r.cfg.vocab, 32, 4, seed=1, device="cpu")
    bs = [data.batch(i) for i in range(25)]
    fails = {7: 1, 12: 2}      # a transient failure at 7; two at 12: restore-and-skip

    def injector(st):
        if fails.get(st, 0):
            fails[st] -= 1
            raise RuntimeError("injected failure")

    seen = {}
    state = loop.LoopState(params=params, opt_state=opt.init(params), masks=None)
    lcfg = loop.LoopConfig(total_steps=15, checkpoint_every=5,
                           checkpoint_dir=str(tmp_path), log_every=100)
    state = loop.run(state, step, iter(bs), lcfg, on_step=lambda i, m: seen.update({i: m}),
                     fail_injector=injector)
    assert state.step == 15 and sorted(seen) == list(range(15))
    assert seen[12].get("skipped") and np.isnan(seen[12]["loss"])
    assert not seen[7].get("skipped") and np.isfinite(seen[7]["loss"])
    assert sorted(os.listdir(tmp_path)) == ["latest", "step-00000005", "step-00000010",
                                            "step-00000014"]
    # resume: a fresh loop picks up after the saved step 14, on batch 15
    got = []
    state2 = loop.LoopState(params=params, opt_state=opt.init(params), masks=None)
    state2 = loop.run(state2, step, iter(bs),
                      loop.LoopConfig(total_steps=18, checkpoint_every=5,
                                      checkpoint_dir=str(tmp_path), log_every=100),
                      on_step=lambda i, m: got.append(i))
    assert state2.step == 18 and got == [15, 16, 17]


@functools.lru_cache(maxsize=None)
def _ref_bf16():
    """The reference's params with bf16 blocks, and its forward on the
    first batch's tokens."""
    r = inputs()
    jtree = jax.tree.map(jnp.asarray, {**r.params, "blocks": jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), r.params["blocks"])})
    return jtree, jax.jit(jzoo.forward, static_argnums=1)(
        jtree, r.jcfg, jnp.asarray(r.batches[0]["tokens"]))


def test_reference_checkpoint_restores_into_port(setup, tmp_path):
    """A params checkpoint the reference's manager wrote (bf16 blocks, f32
    elsewhere) restores into the port bit for bit and gives the same
    forward."""
    r = setup
    jtree, want = _ref_bf16()
    mgr = JCheckpointManager(str(tmp_path), keep=1)
    mgr.save_async(jtree, 3)
    mgr.wait()
    target = port_params(r)
    target["blocks"] = T.map(lambda t: t.to(torch.bfloat16), target["blocks"])
    got, step = CheckpointManager(str(tmp_path)).restore_latest(T.map(torch.zeros_like, target))
    assert step == 3
    for a, b in zip(T.leaves(got), jax.tree.leaves(jtree)):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_array_equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                             else a.dtype).numpy(),
                                      np.asarray(b).view(np.int16 if b.dtype == jnp.bfloat16
                                                         else b.dtype))
    have = zoo.forward(zoo.from_params(r.cfg, got), r.cfg,
                       torch.from_numpy(r.batches[0]["tokens"]))
    _close_leaf(have, want, 1e-5)


def test_port_checkpoint_bf16_bits_and_reference_reads_it(tmp_path):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**16, size=(3, 5), dtype=np.uint16).astype(np.int16)
    bits[np.isnan(bits.view(jnp.bfloat16).astype(np.float32))] = 0   # no NaN payloads
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.from_numpy(bits).view(torch.bfloat16),
                       "c": torch.zeros(5, dtype=torch.int32), "m": torch.ones(4, dtype=torch.bool)}}
    save(str(tmp_path / "ck"), tree, step=7)
    with open(tmp_path / "ck" / "manifest.json") as f:
        man = json.load(f)
    assert [m["dtype"] for m in man["leaves"]] == ["float32", "bfloat16", "int32", "bool"]
    assert man["leaves"][1]["name"] == "['nested']/['b']"
    got, step = restore(str(tmp_path / "ck"), T.map(torch.zeros_like, tree))
    assert step == 7 and got["nested"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["nested"]["b"].view(torch.int16).numpy(), bits)
    for a, b in zip(T.leaves(got), T.leaves(tree)):
        assert torch.equal(a, b)
    jtree = {"a": jnp.zeros((3, 4)), "nested": {"b": jnp.zeros((3, 5), jnp.bfloat16),
                                                "c": jnp.zeros(5, jnp.int32),
                                                "m": jnp.zeros(4, bool)}}
    jgot, jstep = jrestore(str(tmp_path / "ck"), jtree)
    assert jstep == 7
    np.testing.assert_array_equal(np.asarray(jgot["nested"]["b"]).view(np.int16), bits)
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path / "ck"), {**tree, "a": torch.zeros(4, 4)})
