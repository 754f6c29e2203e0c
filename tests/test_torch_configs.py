"""Port parity: the dense family's remaining configurations
(`repro_torch.configs`: qwen2.5-14b, codeqwen1.5-7b, starcoder2-15b and
bert-base) against `repro.configs`, and their models at `reduced()`.

Each config equals the reference's field for field (dtype mapped to the
torch dtype of the same name), as do the MoE family's two.  At `reduced()` (2 layers, d_model 128,
V 8, f32), each config's seeded weights (the port's init, laid out as the
reference's params tree), HiNM-packed by the reference and carried by
`params_from_numpy` — GQA 4/2 and MHA 4/4, the untied
`lm_head`, QKV bias, RMSNorm or LayerNorm with its bias, SwiGLU or the
GELU MLP's biased `wu`/`wd` — give the reference's eval forward, bucketed
prefill and paged decode logits within 1e-4 (sum-order differences only,
as `tests/test_torch_model.py` holds qwen2-0.5b).  The four configs'
reference runs compile side by side on threads.  Every other arch id
still raises with its ROADMAP pointer.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import zoo as jzoo
from repro_torch.configs import base
from repro_torch.convert import params_from_numpy
from repro_torch.core.types import PackedHiNM
from repro_torch.models import paging, zoo
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NEW = ("qwen2_5_14b", "codeqwen1_5_7b", "starcoder2_15b", "bert_base")
# the MoE family's configs (their models: tests/test_torch_moe.py)
MOE = ("granite_moe_3b_a800m", "grok_1_314b")
TOL = 1e-4
MAX_SEQ = 64

j_pack = jax.jit(jzoo.pack_params, static_argnums=0)
j_forward = jax.jit(jzoo.forward, static_argnums=1)
j_prefill = jax.jit(jzoo.prefill, static_argnums=1)
j_decode = jax.jit(jzoo.decode_step, static_argnums=1)
j_insert = jax.jit(jzoo.paged_insert, static_argnums=0)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                               rtol=tol, atol=tol)


def _fields(cfg) -> dict:
    """A config's fields, the dtype by name and HiNM as its fields."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["dtype"] = np.dtype(out["dtype"]).name if not isinstance(
        out["dtype"], torch.dtype) else str(out["dtype"]).split(".")[-1]
    out["hinm"] = dataclasses.asdict(out["hinm"])
    return out


@pytest.mark.parametrize("name", NEW + MOE)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(name, reduced):
    jcfg, cfg = jbase.load_arch(name), base.load_arch(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    assert _fields(cfg) == _fields(jcfg)
    assert (cfg.vocab_padded, cfg.attn_out_dim, cfg.kv_out_dim) == (
        jcfg.vocab_padded, jcfg.attn_out_dim, jcfg.kv_out_dim)


def test_load_arch_loads_ported_and_refuses_the_rest():
    # the vlm and encdec configs: tests/test_torch_vlm.py; xlstm:
    # tests/test_torch_xlstm.py
    assert set(base.PORTED_IDS) == {"qwen2_0_5b", *NEW, *MOE, "phi_3_vision_4_2b",
                                    "deit_base", "seamless_m4t_medium", "xlstm_125m"}
    assert base.load_arch("qwen2_5_14b").draft_arch == "qwen2_0_5b"
    assert set(base.ARCH_IDS + base.PAPER_IDS) - set(base.PORTED_IDS) == {"recurrentgemma_9b"}
    for name in set(base.ARCH_IDS + base.PAPER_IDS) - set(base.PORTED_IDS):
        with pytest.raises(KeyError, match="ROADMAP.md"):
            base.load_arch(name)
    with pytest.raises(KeyError, match="unknown"):
        base.load_arch("no_such_arch")


DECODE_STEPS = 3
PAGE, N_SLOTS = 8, 3
N_PAGES = paging.N_RESERVED + 12


def _inputs():
    """The inputs every config's reference and port runs take: eval-forward
    tokens, a bucketed prefill of two prompts (padding past each lane's
    length), their pages in a paged pool (shuffled; slot 1 idle) and the
    decode steps' tokens.  Token ids are below every reduced vocab."""
    rng = np.random.default_rng(2)
    n_rows = np.array([9, 14], np.int32)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
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
    return dict(forward=rng.integers(0, 512, (2, 12)).astype(np.int32), prefill=toks,
                n_rows=n_rows, inserts=inserts,
                decode=rng.integers(0, 512, (DECODE_STEPS, N_SLOTS, 1)).astype(np.int32))


def _reference_run(name: str, x: dict) -> dict:
    """One config's reference side at `reduced()`: init (seed 0), HiNM
    packing, the eval forward, the bucketed prefill, its rows inserted into
    the paged pool and the decode steps, all as numpy."""
    jcfg = jbase.load_arch(name).reduced()
    # seeded weights in the reference's params tree (the port's init, as
    # the reference lays it out), packed by the reference
    dense = zoo.params_of(base.load_arch(name).reduced(), zoo.init(
        base.load_arch(name).reduced(), torch.Generator().manual_seed(0), "cpu"))
    packed = j_pack(jcfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()), dense))
    out = {"packed": jax.tree.map(np.asarray, packed),
           "forward": j_forward(packed, jcfg, jnp.asarray(x["forward"]))}
    st = jzoo.make_cache(jcfg, 2, MAX_SEQ)
    out["last"], st = j_prefill(packed, jcfg, jnp.asarray(x["prefill"]), st,
                                n_rows=jnp.asarray(x["n_rows"]))
    out["stripe"] = st
    pool = jzoo.make_cache(jcfg, N_SLOTS, MAX_SEQ, page=PAGE, n_pages=N_PAGES)
    for row, slot, ids, bt_row in x["inserts"]:
        pool = j_insert(jcfg, pool, st, slot, row, jnp.asarray(ids), jnp.asarray(bt_row),
                        np.int32(3))
    logits = []
    for tok in x["decode"]:
        lg, pool = j_decode(packed, jcfg, jnp.asarray(tok), pool)
        logits.append(lg)
    out.update(decode=np.stack(logits), pos=pool["pos"])
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def reference():
    """Every new config's reference run, the four compiled and run on
    threads side by side (XLA compiles outside the GIL)."""
    x = _inputs()
    with concurrent.futures.ThreadPoolExecutor(len(NEW)) as ex:
        runs = dict(zip(NEW, ex.map(lambda n: _reference_run(n, x), NEW)))
    return x, runs


@pytest.fixture(scope="module", params=NEW)
def models(request, reference):
    """(port cfg, the reference's packed params and outputs, the inputs,
    the port model over those params)."""
    x, runs = reference
    cfg = base.load_arch(request.param).reduced()
    ref = runs[request.param]
    return cfg, ref, x, params_from_numpy(cfg, ref["packed"], "cpu")


def test_convert_carries_the_family_parts(models):
    """The untied `lm_head`, LayerNorm's bias and the GELU MLP's biased
    wu/wd arrive as the reference holds them."""
    cfg, ref, _, model = models
    packed = ref["packed"]
    np.testing.assert_array_equal(model.lm_head.w.numpy(), packed["lm_head"]["w"])
    assert not np.array_equal(model.lm_head.w.numpy(), model.embed.table.numpy().T)
    blk = model.blocks[1]
    names = {"swiglu": ("wg", "wu", "wd"), "gelu": ("wu", "wd")}[cfg.act]
    assert set(packed["blocks"]["mlp"]) == set(names)
    for n in names:
        lin = getattr(blk.mlp, n)
        assert isinstance(lin.w, PackedHiNM)
        jb = packed["blocks"]["mlp"][n].get("b")
        assert (lin.b is None) == (jb is None) == (cfg.act == "swiglu")
        if jb is not None:
            np.testing.assert_array_equal(lin.b.numpy(), jb[1])
    for n in ("wq", "wk", "wv"):
        np.testing.assert_array_equal(getattr(blk.attn, n).b.numpy(),
                                      packed["blocks"]["attn"][n]["b"][1])
    ln = packed["blocks"]["ln1"]
    assert (blk.ln1.bias is None) == ("bias" not in ln) == (cfg.norm == "rmsnorm")
    if cfg.norm == "layernorm":
        np.testing.assert_array_equal(blk.ln1.bias.numpy(), ln["bias"][1])
        np.testing.assert_array_equal(model.ln_f.bias.numpy(), packed["ln_f"]["bias"])


def test_forward_matches(models):
    cfg, ref, x, model = models
    _close(ref["forward"], zoo.forward(model, cfg, torch.from_numpy(x["forward"])))


def test_bucketed_prefill_and_paged_decode_match(models):
    """Bucketed prefill of two prompts into a stripe, then `paged_insert`
    into a paged pool (shuffled pages, one idle slot) and three decode
    steps: last-token pre-logits, the stripe's K/V and positions, and every
    decode step's logits agree."""
    cfg, ref, x, model = models
    tst = zoo.make_cache(cfg, 2, MAX_SEQ, device="cpu")
    tlast = zoo.prefill(model, cfg, torch.from_numpy(x["prefill"]), tst,
                        n_rows=torch.from_numpy(x["n_rows"]))
    _close(ref["last"], tlast)
    for name in ("k", "v"):
        _close(ref["stripe"][name], tst[name])
    np.testing.assert_array_equal(ref["stripe"]["kpos"], tst["kpos"].numpy())
    tpool = zoo.make_cache(cfg, N_SLOTS, MAX_SEQ, page=PAGE, n_pages=N_PAGES, device="cpu")
    for row, slot, ids, bt_row in x["inserts"]:
        zoo.paged_insert(cfg, tpool, tst, slot, row, torch.from_numpy(ids),
                         torch.from_numpy(bt_row), 3)
    for step, tok in enumerate(x["decode"]):
        _close(ref["decode"][step], zoo.decode_step(model, cfg, torch.from_numpy(tok), tpool))
    np.testing.assert_array_equal(ref["pos"], tpool["pos"].numpy())
