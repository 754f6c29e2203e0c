"""Port parity: the dense transformer (`repro_torch.models`) against
`repro.models` on the same weights, carried across by
`repro_torch.convert.params_from_numpy` — dense and HiNM-packed.

Reduced qwen2-0.5b in f32 (2 layers, d_model 128, V = 8): eval forward,
bucketed prefill into a stripe cache, and decode steps on a paged cache
built by `paged_insert` agree within 1e-4 (sum-order differences only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import load_arch as jload_arch
from repro.models import paging as jpaging
from repro.models import zoo as jzoo
from repro_torch.configs.base import load_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.types import PackedHiNM
from repro_torch.models import paging, zoo

TOL = 1e-4
MAX_SEQ = 64

# the reference entry points under jit (cfg static): one compile per
# weight layout instead of one per eager op keeps this file fast
j_init = jax.jit(jzoo.init, static_argnums=1)
j_pack = jax.jit(jzoo.pack_params, static_argnums=0)
j_forward = jax.jit(jzoo.forward, static_argnums=1)
j_prefill = jax.jit(jzoo.prefill, static_argnums=1)
j_decode = jax.jit(jzoo.decode_step, static_argnums=1)
j_insert = jax.jit(jzoo.paged_insert, static_argnums=(0, 3, 4))


@pytest.fixture(scope="module")
def models():
    jcfg = jload_arch("qwen2_0_5b").reduced()
    cfg = load_arch("qwen2_0_5b").reduced()
    dense = j_init(jax.random.PRNGKey(0), jcfg)
    packed = j_pack(jcfg, dense)
    out = {}
    for mode, jp in (("dense", dense), ("packed", packed)):
        out[mode] = (jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu"))
    return jcfg, cfg, out


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                               rtol=tol, atol=tol)


def test_convert_keeps_layout_and_index_types(models):
    _, cfg, out = models
    dense, packed = out["dense"][1], out["packed"][1]
    assert len(packed.blocks) == cfg.n_layers
    assert dense.blocks[0].attn.wq.w.shape == (cfg.d_model, cfg.attn_out_dim)
    for blk in packed.blocks:
        for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                    blk.mlp.wg, blk.mlp.wu, blk.mlp.wd):
            assert isinstance(lin.w, PackedHiNM)
            assert lin.w.vec_idx.dtype == torch.int32 and lin.w.nm_idx.dtype == torch.int8
    assert not isinstance(packed.lm_head.w, PackedHiNM)


@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_forward_matches(models, mode):
    jcfg, cfg, out = models
    jp, model = out[mode]
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    ref = j_forward(jp, jcfg, jnp.asarray(toks))
    got = zoo.forward(model, cfg, torch.from_numpy(toks))
    _close(ref, got)


def test_pack_params_in_port_matches_reference_packing(models):
    jcfg, cfg, out = models
    port_packed = zoo.pack_params(cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, out["dense"][0]), "cpu"))
    ref = out["packed"][1]
    for a, b in zip(port_packed.blocks, ref.blocks):
        for path in ("attn/wq", "attn/wv", "mlp/wu", "mlp/wd"):
            pa, pb = (zoo.M.get_path(blk, path).w for blk in (a, b))
            assert torch.equal(pa.vals, pb.vals) and torch.equal(pa.vec_idx, pb.vec_idx)
            assert torch.equal(pa.nm_idx, pb.nm_idx)
    # and back: unpack_params restores masked-dense (n_in, n_out) weights
    zoo.unpack_params(cfg, port_packed)
    w = port_packed.blocks[0].mlp.wd.w
    assert isinstance(w, torch.Tensor) and w.shape == (cfg.d_ff, cfg.d_model)


def _prefill_both(jcfg, cfg, jp, model, toks, n_rows):
    jc = jzoo.make_cache(jcfg, toks.shape[0], MAX_SEQ)
    jlast, jc = j_prefill(jp, jcfg, jnp.asarray(toks), jc, n_rows=jnp.asarray(n_rows))
    tc = zoo.make_cache(cfg, toks.shape[0], MAX_SEQ, device="cpu")
    tlast = zoo.prefill(model, cfg, torch.from_numpy(toks), tc,
                        n_rows=torch.from_numpy(n_rows))
    return jlast, jc, tlast, tc


@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_bucketed_prefill_matches(models, mode):
    jcfg, cfg, out = models
    jp, model = out[mode]
    n_rows = np.array([5, 16, 11], np.int32)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (3, 16)).astype(np.int32)
    for i, n in enumerate(n_rows):
        toks[i, n:] = 0                                   # bucket padding
    jlast, jc, tlast, tc = _prefill_both(jcfg, cfg, jp, model, toks, n_rows)
    _close(jlast, tlast)
    for name in ("k", "v"):
        _close(jc[name], tc[name])
    np.testing.assert_array_equal(np.asarray(jc["kpos"]), tc["kpos"].numpy())
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())


@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_paged_decode_matches(models, mode):
    """Prefill two prompts on a stripe, scatter them into a paged pool with
    `paged_insert` (shuffled physical pages, one idle slot), then 3 decode
    steps: logits and the whole pool agree."""
    jcfg, cfg, out = models
    jp, model = out[mode]
    rng = np.random.default_rng(3)
    n_rows = np.array([9, 14], np.int32)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    _, jst, _, tst = _prefill_both(jcfg, cfg, jp, model, toks, n_rows)
    page, n_slots = 8, 3
    n_bt = MAX_SEQ // page
    n_pages = paging.N_RESERVED + 12
    jpool = jzoo.make_cache(jcfg, n_slots, MAX_SEQ, page=page, n_pages=n_pages)
    tpool = zoo.make_cache(cfg, n_slots, MAX_SEQ, page=page, n_pages=n_pages,
                           device="cpu")
    free = list(rng.permutation(np.arange(paging.N_RESERVED, n_pages)))
    for row, slot in ((0, 2), (1, 0)):
        n_alloc = 3
        pages = [int(free.pop()) for _ in range(n_alloc)]
        ids = np.full((n_bt,), paging.SCRATCH_PAGE, np.int32)
        bt_row = np.full((n_bt,), paging.SENTINEL_PAGE, np.int32)
        ids[:n_alloc] = bt_row[:n_alloc] = pages
        jpool = j_insert(jcfg, jpool, jst, slot, row, jnp.asarray(ids),
                         jnp.asarray(bt_row), np.int32(n_alloc))
        zoo.paged_insert(cfg, tpool, tst, slot, row, torch.from_numpy(ids),
                         torch.from_numpy(bt_row), n_alloc)
    assert jpaging.SCRATCH_PAGE == paging.SCRATCH_PAGE
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (n_slots, 1)).astype(np.int32)
        jlog, jpool = j_decode(jp, jcfg, jnp.asarray(tok), jpool)
        tlog = zoo.decode_step(model, cfg, torch.from_numpy(tok), tpool)
        # slot 1 is idle (its writes land on the scratch page, every key it
        # sees is masked): its defined-but-unused output must agree too
        _close(jlog, tlog)
    for name in ("k", "v"):
        _close(np.asarray(jpool[name])[:, paging.N_RESERVED:],
               tpool[name].numpy()[:, paging.N_RESERVED:])
    for name in ("kpos", "pos", "bt", "alloc"):
        got = tpool[name].numpy()
        want = np.asarray(jpool[name])
        if name == "kpos":
            got, want = got[:, paging.N_RESERVED:], want[:, paging.N_RESERVED:]
        np.testing.assert_array_equal(want, got)
