"""The reference package's side of `tests/test_torch_train_families.py`,
run in worker processes of its own.

Every job here compiles the reference's programs (each family's loss
gradient and train steps, its `recompute_masks`, a gyro search's cost
helpers); `test_torch_train_families`'s fixture starts them in three
spawned processes, which run beside the port's side.  Each function takes
and returns numpy arrays and plain Python values only.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np

# the five families at `reduced()`: phi-3's 576 patch rows cut to 8, as
# tests/test_models.py cuts them; recurrentgemma's window cut to 16, so
# that its attention layers' window takes effect over the 32 tokens
FAMILIES = {
    "granite_moe_3b_a800m": {},
    "phi_3_vision_4_2b": dict(frontend_tokens=8),
    "seamless_m4t_medium": {},
    "xlstm_125m": {},
    "recurrentgemma_9b": dict(window=16),
}
B, S = 2, 32                 # a batch: B rows of S tokens (an encdec: S frames)
LR = (1e-2, 5, 100)          # cosine_schedule(base, warmup, total)
STEP = 3                     # the step index the one AdamW step runs at
# the masks every family trains under: (vector sparsity, N:M on); the
# settings `recompute_masks` is compared at, and on which families
MASKS = (0.5, True)
RECOMPUTE = ((0.3, False), (0.5, True))
RECOMPUTED = ("granite_moe_3b_a800m", "xlstm_125m", "recurrentgemma_9b")
# where two microbatches compute another function than one batch: an MoE
# gives each microbatch its own expert capacity.  Elsewhere they differ
# only in rounding, and the port's two-microbatch step is held to the
# reference's one-batch step (which spares a compile of the backward)
MICRO = ("granite_moe_3b_a800m",)
# granite's virtual refresh: tests/test_torch_moe.py's config (d_ff =
# d_model: fewer search programs), gyro 2/2, the schedule's N:M switch
REFRESH = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
               head_dim=16)
REFRESH_ITERS = (2, 2)
NM_STEP = 6
# causal block skipping at small blocks: q/kv blocks of 8 over 32 tokens
BLOCK = 8
SKIP_ATTN = dict(b=2, s=32, h=4, kv=2, hd=8)
SKIP_WINDOWS = (0, 16)
# tests/test_train.py's reduced qwen2-0.5b
QWEN = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
            head_dim=16)


def _jcfg(arch, overrides):
    from repro.configs.base import load_arch

    return load_arch(arch).reduced(**overrides)


def _hcfg(sparsity):
    from repro.core.types import HiNMConfig

    return HiNMConfig(v=8, n=2, m=4, vector_sparsity=sparsity)


def _loss_fn(jcfg):
    from repro.models import zoo
    from repro.train import pruning, steps

    def loss_fn(params, masks, batch):
        p = pruning.apply_masks(params, masks)
        x = zoo.forward(p, jcfg, batch["tokens"], embeds=batch.get("embeds"))
        return steps.chunked_xent(p, jcfg, x, batch["labels"])

    return loss_fn


def family(arch, tree, batch):
    """On `arch`'s reduced config with the weights `tree`: its
    `recompute_masks` at MASKS (on a family of RECOMPUTED, at each of
    RECOMPUTE); then under the MASKS masks, in one jitted program, the
    loss and its gradients; one AdamW step at STEP on them
    (`make_train_step`'s step body: clip, `update`, the masks
    re-applied); and, on a family of MICRO, `make_train_step`'s own step
    with two microbatches: the new params, optimizer state and metrics of
    each."""
    from repro import optim
    from repro.launch.mesh import make_host_mesh
    from repro.train import gradual, pruning, steps

    jcfg = _jcfg(arch, FAMILIES[arch])
    params = jax.tree.map(jnp.asarray, tree)
    fn = jax.jit(gradual.recompute_masks, static_argnums=(1, 2, 3))
    out = {"recompute": {(sp, nm): jax.tree.map(np.asarray, fn(params, jcfg, _hcfg(sp), nm))
                         for sp, nm in (RECOMPUTE if arch in RECOMPUTED else (MASKS,))}}
    masks = out["recompute"][MASKS]
    lr = optim.cosine_schedule(*LR)
    step2 = steps.make_train_step(jcfg, make_host_mesh(), lr_fn=lr, microbatches=2)[0]
    opt = optim.make_optimizer("adamw")

    def run(params, masks, batch):
        loss, grads = jax.value_and_grad(_loss_fn(jcfg))(params, masks, batch)
        state = opt.init(params)
        clipped, gnorm = optim.clip_by_global_norm(grads, 1.0)
        new, new_state = opt.update(clipped, state, params, lr(STEP))
        step1 = (pruning.apply_masks(new, masks), new_state, {"loss": loss, "grad_norm": gnorm})
        out = dict(loss=loss, grads=grads, step1=step1)
        if arch in MICRO:
            out["step2"] = step2(params, state, masks, batch, STEP)[:3]
        return out

    res = jax.jit(run)(params, jax.tree.map(jnp.asarray, masks),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    out.update(jax.tree.map(np.asarray, res))
    return out


def refresh(tree):
    """granite REFRESH with the weights `tree`: the reference's
    `make_mask_schedule` at its N:M switch, the virtual gyro refresh
    (`prune_model(permute_params=False)`, seeded with the step) at
    REFRESH_ITERS."""
    from repro.train import gradual, pruning

    jcfg = _jcfg("granite_moe_3b_a800m", REFRESH)
    orig = pruning.prune_model
    pruning.prune_model = functools.partial(orig, ocp_iters=REFRESH_ITERS[0],
                                            icp_iters=REFRESH_ITERS[1], workers=4)
    try:
        sched = gradual.GradualSchedule(target=jcfg.hinm, vector_end_step=4, nm_step=NM_STEP,
                                        update_every=2)
        cb = gradual.make_mask_schedule(jcfg, sched)
        state = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, tree))
        return jax.tree.map(np.asarray, cb(NM_STEP, state))
    finally:
        pruning.prune_model = orig


def _small_blocks(orig):
    """`_attn_chunked` at q/kv blocks of BLOCK, whatever its caller asks."""

    def call(q, k, v, q_pos, k_pos, causal, window, *args, aligned=False):
        return orig(q, k, v, q_pos, k_pos, causal, window, BLOCK, BLOCK, aligned=aligned)

    return call


def block_skip(attn_in, tree, batch):
    """The knob on: `_attn_chunked` at q/kv blocks of BLOCK, causal and
    aligned, for each of SKIP_WINDOWS: its output and the vjp of
    ``attn_in["ct"]`` with respect to q, k and v; and the reduced
    qwen2-0.5b's loss and gradients with every attention at blocks of
    BLOCK."""
    from repro.models import layers
    from repro.perf_knobs import knobs
    from repro.train import gradual

    out = {}
    q, k, v, pos, ct = (jnp.asarray(attn_in[n]) for n in ("q", "k", "v", "pos", "ct"))
    for w in SKIP_WINDOWS:
        def f(q, k, v, w=w):
            return layers._attn_chunked(q, k, v, pos, pos, True, w, BLOCK, BLOCK,
                                        aligned=True)

        def run(q, k, v, f=f):
            o, vjp = jax.vjp(f, q, k, v)
            return o, vjp(ct)

        with knobs(causal_block_skip=True):     # read while tracing
            o, g = jax.jit(run)(q, k, v)
        out[w] = (np.asarray(o), [np.asarray(t) for t in g])
    jcfg = _jcfg("qwen2_0_5b", QWEN)
    params = jax.tree.map(jnp.asarray, tree)
    ones = gradual.recompute_masks(params, jcfg, _hcfg(0.0), False)
    orig, layers._attn_chunked = layers._attn_chunked, _small_blocks(layers._attn_chunked)
    try:
        with knobs(causal_block_skip=True):
            loss, grads = jax.jit(jax.value_and_grad(_loss_fn(jcfg)))(
                params, ones, {n: jnp.asarray(a) for n, a in batch.items()})
    finally:
        layers._attn_chunked = orig
    out["qwen"] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


def restore(path, target):
    """The reference's `restore` of the checkpoint at `path` into the
    structure of `target` (numpy): (tree, step)."""
    from repro.checkpoint import restore as jrestore

    tree, step = jrestore(path, jax.tree.map(jnp.asarray, target))
    return jax.tree.map(np.asarray, tree), step


def save(path, tree, step):
    """`tree` (numpy) written by the reference's CheckpointManager at
    `step` under `path`."""
    from repro.checkpoint import CheckpointManager

    mgr = CheckpointManager(path, keep=1)
    mgr.save_async(jax.tree.map(jnp.asarray, tree), step)
    mgr.wait()


def run_group(jobs):
    """Each of `jobs` ({name: (function name, args)}) in turn, here."""
    return {name: globals()[fn](*args) for name, (fn, args) in jobs.items()}
