"""Port parity: training of the MoE, vlm, encdec, ssm and hybrid families
(`repro_torch.train.steps`, `train.gradual`, `checkpoint`) and causal
block skipping in training attention (`layers._attn_chunked`), against
`repro` on the same numpy inputs, on the CPU.

Models: granite-3.0 MoE, phi-3-vision (8 patch rows), seamless-m4t-medium,
xlstm-125m and recurrentgemma-9b (window 16) at `reduced()`, f32 (every
reduced config is f32, so no bf16 tolerance is needed); the port's seeded
init laid out as the reference's params tree (`zoo.params_of`).  A batch
is `SyntheticLMData` (seed 1) plus a seeded normal draw, in the
reference's shapes (`tests/test_models.py`'s `tiny_batch`,
`data.pipeline.make_batch_specs`): a vlm's tokens (2, 32), patch rows
(2, 8, D) and labels (2, 40); an encdec's frames (2, 32, D) and tokens and
labels (2, 8); the others' tokens and labels (2, 32).  Every family trains
under the masks `recompute_masks` gives at vector sparsity 0.5 with N:M on.

- The masked loss within 1e-5 relative, and its gradients within 1e-4 of
  each leaf's max.  A leaf whose gradient is zero in exact arithmetic
  (xlstm's mLSTM input-gate bias: the state's normaliser divides out a
  shift common to every token's gate) holds rounding noise only; there
  both sides must be under ZERO_GRAD of the tree's largest gradient.
- One AdamW step (`make_train_step`, one batch and two microbatches)
  against the reference's jitted step: loss within 1e-5, gradient norm
  within 1e-4, params and moments within 1e-4 of each leaf's max outside
  the gradients' noise floor (`_free`, `tests/test_torch_train.py`'s rule,
  plus the zero leaves above, whose noise AdamW turns into a full step).
- The two faults repaired: `loss_fn` passes a vlm's or encdec's embeds
  (the loss differs without them); `recompute_masks` maps over every
  leading axis, so granite's (L, E, n_in, n_out) expert stacks get each
  expert's own mask.
- `recompute_masks` gives the reference's masks bit for bit on granite,
  xlstm and recurrentgemma; each family's PermGraph instances are the
  reference's `_planned_paths`.
- Granite's gradual schedule at its N:M switch (the virtual gyro refresh,
  2/2, tests/test_torch_moe.py's config) gives the reference's masks over
  the expert stacks, its search scored with the reference's own cost
  helpers (ROADMAP Queue 3's f32 tie rule).
- A trained granite and recurrentgemma tree (params and AdamW state)
  checkpoints from the port into the reference and back, bit for bit,
  with the reference's manifest names.
- AdamW over a leaf larger than `optimizers.ADAMW_SLICE` (a slice of its
  first axis at a time) is bit for bit the whole-leaf update.
- Causal block skipping (`KNOBS.causal_block_skip`, off by default):
  `_attn_chunked` at q/kv blocks of 8 over 32 tokens, windows 0 and 16,
  and the reduced qwen2-0.5b's loss and gradients at those blocks equal
  the reference's with the knob on (1e-5 / 1e-4 of each leaf's max).

The reference's side runs in three spawned processes beside the port's
(`tests/torch_train_families_ref.py`).
"""
import functools
import json
import multiprocessing
import os
import types
from concurrent.futures import ProcessPoolExecutor

import jax
import numpy as np
import pytest
import torch

import torch_train_families_ref as ref
from repro.configs.base import load_arch as jload_arch
from repro.train.abstract import _planned_paths
from repro_torch import perf_knobs
from repro_torch import tree as T
from repro_torch.checkpoint import restore, save
from repro_torch.configs.base import load_arch
from repro_torch.core.types import HiNMConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import layers, zoo
from repro_torch.optim import cosine_schedule, optimizers
from repro_torch.train import gradual, pruning, steps
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_train_ref import reference_search_costs

FAMILIES = list(ref.FAMILIES)
GRANITE, HYBRID = "granite_moe_3b_a800m", "recurrentgemma_9b"
FRONTEND = ["phi_3_vision_4_2b", "seamless_m4t_medium"]
RECOMPUTED = [GRANITE, "xlstm_125m", HYBRID]
CHECKPOINTED = [GRANITE, HYBRID]
# a gradient leaf whose reference max is under this share of the tree's
# largest is zero in exact arithmetic (see the module docstring)
ZERO_GRAD = 1e-6
# the reference's jobs, one group a spawned process, balanced by their
# seconds (recurrentgemma's programs compile slowest)
GROUPS = ([HYBRID, "xlstm_125m"], ["block_skip", GRANITE],
          ["seamless_m4t_medium", "refresh", "phi_3_vision_4_2b"])


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _cfg(arch):
    return load_arch(arch).reduced(**ref.FAMILIES.get(arch, {}))


def _init_tree(cfg, seed):
    return zoo.params_of(cfg, zoo.init(cfg, torch.Generator().manual_seed(seed), "cpu"))


def _batch(cfg, seed=1):
    """The family's batch, numpy, in the reference's shapes."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "patch":
        p = cfg.frontend_tokens
        b = SyntheticLMData(cfg.vocab, p + ref.S, ref.B, seed=seed, device="cpu").batch(0)
        out = dict(tokens=b["tokens"][:, p:], labels=b["labels"],
                   embeds=rng.standard_normal((ref.B, p, cfg.d_model)))
    elif cfg.frontend == "frames":
        out = dict(SyntheticLMData(cfg.vocab, ref.S // 4, ref.B, seed=seed,
                                   device="cpu").batch(0),
                   embeds=rng.standard_normal((ref.B, ref.S, cfg.d_model)))
    else:
        out = SyntheticLMData(cfg.vocab, ref.S, ref.B, seed=seed, device="cpu").batch(0)
    return {k: (np.asarray(v, np.float32) if k == "embeds" else np.asarray(v, np.int32))
            for k, v in out.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v if k == "embeds" else v.astype(np.int64))
            for k, v in batch.items()}


def _masks(params, cfg, sparsity, nm_on):
    return gradual.recompute_masks(params, cfg, HiNMConfig(v=8, n=2, m=4,
                                                           vector_sparsity=sparsity), nm_on)


def _attn_inputs():
    d = ref.SKIP_ATTN
    rng = np.random.default_rng(9)
    q, k, v, ct = (rng.standard_normal((d["b"], d["s"], n, d["hd"])).astype(np.float32)
                   for n in (d["h"], d["kv"], d["kv"], d["h"]))
    pos = np.broadcast_to(np.arange(d["s"], dtype=np.int32), (d["b"], d["s"])).copy()
    return dict(q=q, k=k, v=v, ct=ct, pos=pos)


def _attempt(fn, *args):
    """fn(*args), or the exception it raised: the fixture keeps going, and
    each test that reads the result raises it (`_value`)."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 (re-raised by `_value`)
        return e


def _value(x):
    if isinstance(x, Exception):
        raise x
    return x


def _port_family(arch, params, batch):
    """The port's MASKS masks, its masked loss and gradients, and one AdamW
    step with one batch and with two microbatches (and the two
    microbatches' gradients, for their noise floor)."""
    cfg, tb = _cfg(arch), _tbatch(batch)
    masks = _masks(params, cfg, *ref.MASKS)
    out = dict(masks=masks, grads=steps.value_and_grad(params, cfg, masks, tb),
               grads2=steps.accumulate_grads(params, cfg, masks, tb, 2, torch.float32))
    for mb in (1, 2):
        step, opt = steps.make_train_step(cfg, lr_fn=cosine_schedule(*ref.LR), microbatches=mb)
        out[f"step{mb}"] = step(params, opt.init(params), masks, tb, ref.STEP)[:3]
    return out


@pytest.fixture(scope="module")
def setup():
    """Each family's weights and batch; the reference's runs (`GROUPS`) in
    three spawned processes; beside them the port's masks, loss,
    gradients and steps, and granite's gradual refresh."""
    trees = {a: _init_tree(_cfg(a), i) for i, a in enumerate(FAMILIES)}
    batches = {a: _batch(_cfg(a)) for a in FAMILIES}
    rcfg = load_arch(GRANITE).reduced(**ref.REFRESH)
    rtree = _init_tree(rcfg, 0)
    qcfg = load_arch("qwen2_0_5b").reduced(**ref.QWEN)
    qtree = _init_tree(qcfg, 0)
    qbatch = _batch(qcfg)
    attn_in = _attn_inputs()
    as_np = functools.partial(T.map, lambda t: t.numpy())
    args = {a: ("family", (a, as_np(trees[a]), batches[a])) for a in FAMILIES}
    args["refresh"] = ("refresh", (as_np(rtree),))
    args["block_skip"] = ("block_skip", (attn_in, as_np(qtree), qbatch))
    with ProcessPoolExecutor(len(GROUPS), mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = [ex.submit(ref.run_group, {n: args[n] for n in group}) for group in GROUPS]
        port = {a: _attempt(_port_family, a, trees[a], batches[a]) for a in FAMILIES}
        refreshed = _attempt(_port_refresh, rcfg, rtree)
        want = {}
        for f in futs:
            want.update(f.result())
    return dict(trees=trees, batches=batches, port=port, want=want, refresh=(rcfg, refreshed),
                qwen=(qcfg, qtree, qbatch), attn_in=attn_in)


def _port_refresh(cfg, params):
    """The port's `make_mask_schedule` at its N:M switch, its search at
    REFRESH_ITERS scored with the reference's cost helpers."""
    sched = gradual.GradualSchedule(target=cfg.hinm, vector_end_step=4, nm_step=ref.NM_STEP,
                                    update_every=2)
    cb = gradual.make_mask_schedule(cfg, sched)
    with pytest.MonkeyPatch.context() as mp:
        reference_search_costs(mp)
        mp.setattr(pruning, "prune_model", functools.partial(
            pruning.prune_model, ocp_iters=ref.REFRESH_ITERS[0],
            icp_iters=ref.REFRESH_ITERS[1], workers=2))
        return cb(ref.NM_STEP, types.SimpleNamespace(params=params)), cb.refreshes


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _pairs(got, want):
    """(name, port leaf, reference leaf) in `jax.tree` order, names checked."""
    g, w = T.leaves_with_names(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(g) == len(w)
    out = []
    for (name, a), (path, b) in zip(g, w):
        assert name == "/".join(str(k) for k in path)
        out.append((name, a, np.asarray(b)))
    return out


def _zero_leaves(want_grads) -> set:
    """Names of the gradient leaves that are zero in exact arithmetic."""
    leaves = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    top = max(float(np.abs(b).max()) for _, b in leaves)
    return {"/".join(str(k) for k in p) for p, b in leaves
            if float(np.abs(b).max()) < ZERO_GRAD * top}


def _close_grads(got, want, rel=1e-4):
    zero, pairs = _zero_leaves(want), _pairs(got, want)
    top = max(float(np.abs(b).max()) for _, _, b in pairs)
    for name, a, b in pairs:
        a = _np(a).astype(np.float64)
        if name in zero:
            assert max(float(np.abs(a).max()), float(np.abs(b).max())) < ZERO_GRAD * top, name
            continue
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=name)


def _free(grads, want_grads, floor=1e-3) -> dict:
    """The elements no comparison of stepped params can hold: a nonzero
    gradient under `floor` x its leaf's max (tests/test_torch_train.py's
    noise floor), and every element of a zero leaf; in the params and
    their moments."""
    zero, out = _zero_leaves(want_grads), {}
    for name, g in T.leaves_with_names(grads):
        m = ((g != 0) & (g.abs() < floor * g.abs().max())).numpy()
        if name in zero:
            m = np.ones_like(m)
        out.update({f"{pre}{name}": m for pre in ("", "['mu']/", "['nu']/")})
    return out


def _close_tree(got, want, rel, free=None):
    for name, a, b in _pairs(got, want):
        a, b = _np(a).astype(np.float64), np.asarray(b, np.float64)
        scale = max(float(np.abs(b).max()), 1e-30)
        m = (free or {}).get(name)
        if m is not None:
            a, b = a[~m], b[~m]
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=name)


def _bits_equal(got, want):
    for name, a, b in _pairs(got, want):
        assert a.dtype == torch.from_numpy(np.zeros(0, b.dtype)).dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


# ---------------------------------------------------------------------------
# the train step over every family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match(setup, arch):
    port = _value(setup["port"][arch])
    want, (loss, grads) = setup["want"][arch], port["grads"]
    np.testing.assert_allclose(float(loss), float(want["loss"]), rtol=1e-5)
    _close_grads(grads, want["grads"])
    # a masked coordinate gets no gradient
    masks = port["masks"]
    for key, node in zoo.perm_graph(_cfg(arch)).instances():
        g = pruning.get_node(grads, key, node.path)["w"]
        m = pruning.get_node(masks, key, node.path)["w"]
        assert float(g[~m].abs().max()) == 0 and float(g[m].abs().max()) > 0, node.path


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_adamw_step_matches_reference(setup, arch, mb):
    want, port = setup["want"][arch], _value(setup["port"][arch])
    params, opt_state, met = port[f"step{mb}"]
    jparams, jopt, jmet = want["step2" if mb == 2 and arch in ref.MICRO else "step1"]
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    free = _free(port["grads" if mb == 1 else "grads2"][1], want["grads"])
    _close_tree(params, jparams, 1e-4, free)
    _close_tree(opt_state, jopt, 1e-4, free)
    for k, node in zoo.perm_graph(_cfg(arch)).instances():   # masks re-applied
        w = pruning.get_node(params, k, node.path)["w"]
        m = pruning.get_node(port["masks"], k, node.path)["w"]
        assert float(w[~m].abs().max()) == 0


@pytest.mark.parametrize("arch", FRONTEND)
def test_loss_fn_passes_embeds(setup, arch):
    """The reference's loss needs the batch's embeds: a vlm's patch rows
    (its labels cover them) and an encdec's frames."""
    cfg, want = _cfg(arch), setup["want"][arch]
    params, batch = setup["trees"][arch], _tbatch(setup["batches"][arch])
    masks = _masks(params, cfg, *ref.MASKS)
    loss = steps.loss_fn(params, cfg, masks, batch)
    np.testing.assert_allclose(float(loss), float(want["loss"]), rtol=1e-5)
    other = steps.loss_fn(params, cfg, masks, {**batch, "embeds": 2 * batch["embeds"]})
    assert abs(float(other) - float(loss)) > 1e-4


# ---------------------------------------------------------------------------
# gradual pruning
# ---------------------------------------------------------------------------


def test_expert_stack_masks_are_each_experts_own(setup):
    """`recompute_masks` on an (L, E, n_in, n_out) stack: expert e of layer
    l gets the single-matrix mask of its own weight."""
    cfg, params = _cfg(GRANITE), setup["trees"][GRANITE]
    hcfg = HiNMConfig(v=8, n=2, m=4, vector_sparsity=0.5)
    masks = gradual.recompute_masks(params, cfg, hcfg, True)
    for name in ("wg", "wu", "wd"):
        w, m = params["blocks"]["moe"][name]["w"], masks["blocks"]["moe"][name]["w"]
        assert m.shape == w.shape and m.dtype == torch.bool
        for li in range(w.shape[0]):
            for e in range(w.shape[1]):
                assert torch.equal(m[li, e], gradual._mask_for_weight(w[li, e], hcfg, True))
        assert abs(float(m.float().mean()) - 0.25) < 1e-6


@pytest.mark.parametrize("setting", ref.RECOMPUTE, ids=lambda s: f"{s}")
@pytest.mark.parametrize("arch", RECOMPUTED)
def test_recompute_masks_match_reference(setup, arch, setting):
    got = _masks(setup["trees"][arch], _cfg(arch), *setting)
    _bits_equal(got, setup["want"][arch]["recompute"][setting])


@pytest.mark.parametrize("arch", FAMILIES)
def test_perm_graph_instances_are_planned_paths(arch):
    jcfg = jload_arch(arch).reduced(**ref.FAMILIES[arch])
    want = [(key if sel is None else f"stack{sel}", spec.path)
            for key, sel, spec in _planned_paths(jcfg)]
    assert [(k, n.path) for k, n in zoo.perm_graph(_cfg(arch)).instances()] == want


def test_granite_virtual_refresh_matches_reference(setup):
    cfg, refreshed = setup["refresh"]
    masks, refreshes = _value(refreshed)
    want = setup["want"]["refresh"]
    _bits_equal(masks, want)
    assert [e["step"] for e in refreshes] == [ref.NM_STEP]
    assert refreshes[0]["report"].searches_run > 0
    stack = masks["blocks"]["moe"]["wd"]["w"]
    assert stack.shape == (cfg.n_layers, cfg.n_experts, cfg.d_ff, cfg.d_model)
    # every planned projection at the target density: K of n_in kept, N of M
    for m in (leaf for leaf in T.leaves(masks)):
        k = cfg.hinm.kept_columns(m.shape[-2])
        assert float(m.float().mean()) == pytest.approx(k / m.shape[-2] * cfg.hinm.n
                                                        / cfg.hinm.m, abs=1e-6)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", CHECKPOINTED)
def test_trained_tree_checkpoints_both_ways(setup, arch, tmp_path):
    params, opt_state, _ = _value(setup["port"][arch])["step1"]
    tree = {"opt": opt_state, "params": params}
    save(str(tmp_path / "port"), tree, step=ref.STEP)
    target = T.map(lambda t: np.zeros(t.shape, t.numpy().dtype), tree)
    got, step = ref.restore(str(tmp_path / "port"), target)
    assert step == ref.STEP
    _bits_equal(tree, got)
    # the reference's own stepped tree, written by its manager
    jparams, jopt, _ = setup["want"][arch]["step1"]
    ref.save(str(tmp_path / "ref"), {"opt": jopt, "params": jparams}, ref.STEP + 1)
    with open(tmp_path / "ref" / f"step-{ref.STEP + 1:08d}" / "manifest.json") as f:
        jman = json.load(f)
    with open(tmp_path / "port" / "manifest.json") as f:
        man = json.load(f)
    assert [m["name"] for m in man["leaves"]] == [m["name"] for m in jman["leaves"]]
    back, step = restore(os.fspath(tmp_path / "ref" / f"step-{ref.STEP + 1:08d}"),
                         T.map(torch.zeros_like, tree))
    assert step == ref.STEP + 1
    _bits_equal(back, {"opt": jopt, "params": jparams})


# ---------------------------------------------------------------------------
# causal block skipping
# ---------------------------------------------------------------------------


def test_causal_block_skip_is_off_by_default():
    assert perf_knobs.Knobs().causal_block_skip is False
    assert perf_knobs.KNOBS.causal_block_skip is False


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("window", ref.SKIP_WINDOWS)
def test_attn_chunked_block_skip_matches_reference(setup, window, on):
    x = setup["attn_in"]
    q, k, v = (torch.from_numpy(x[n]).requires_grad_() for n in "qkv")
    pos = torch.from_numpy(x["pos"])
    with perf_knobs.knobs(causal_block_skip=on):
        out = layers._attn_chunked(q, k, v, pos, pos, True, window, ref.BLOCK, ref.BLOCK,
                                   aligned=True)
        grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(x["ct"]))
    want, wgrads = setup["want"]["block_skip"][window]
    np.testing.assert_allclose(_np(out), want, rtol=0, atol=1e-5 * np.abs(want).max())
    for g, w in zip(grads, wgrads):
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=1e-4 * np.abs(w).max())


def _small_blocks(orig):
    def call(q, k, v, q_pos, k_pos, causal, window, *args, aligned=False):
        return orig(q, k, v, q_pos, k_pos, causal, window, ref.BLOCK, ref.BLOCK,
                    aligned=aligned)

    return call


def test_train_loss_and_grads_with_block_skip_match(setup, monkeypatch):
    """The reduced qwen2-0.5b at q/kv blocks of 8 (four query chunks), the
    knob on: the reference's loss and gradients; and the knob off gives
    the same loss."""
    cfg, params, batch = setup["qwen"]
    monkeypatch.setattr(layers, "_attn_chunked", _small_blocks(layers._attn_chunked))
    tb = _tbatch(batch)
    with perf_knobs.knobs(causal_block_skip=True):
        loss, grads = steps.value_and_grad(params, cfg, None, tb)
    want_loss, want = setup["want"]["block_skip"]["qwen"]
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _close_grads(grads, want)
    off = steps.value_and_grad(params, cfg, None, tb)[0]
    np.testing.assert_allclose(float(off), float(loss), rtol=1e-6)


# ---------------------------------------------------------------------------
# AdamW over a large leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_adamw_sliced_update_equals_whole_leaf(monkeypatch, dtype):
    """A leaf over `ADAMW_SLICE` elements is updated a slice of its first
    axis at a time: bit for bit the whole-leaf update (which
    tests/test_torch_train.py holds to the reference's); the inputs stay
    as they were."""
    gen = torch.Generator().manual_seed(4)
    params = {"table": torch.randn(37, 64, generator=gen).to(dtype),
              "stack": torch.randn(3, 5, 40, generator=gen).to(dtype),
              "scale": torch.randn(300, generator=gen).to(dtype)}
    orig = T.map(torch.clone, params)
    trees = []
    for limit in (1 << 40, 100):
        monkeypatch.setattr(optimizers, "ADAMW_SLICE", limit)
        p, st = params, optimizers.adamw_init(params)
        for i in range(3):
            g = {k: (torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
                     * 10.0 ** (i - 2)).to(dtype) for k, v in params.items()}
            p, st = optimizers.adamw_update(g, st, p, 1e-2 * (i + 1))
        trees.append((p, st))
    (p1, s1), (p2, s2) = trees
    for a, b in zip(T.leaves((p1, s1)), T.leaves((p2, s2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the update is functional: an f32 leaf's .float() is the leaf itself
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(orig)))
