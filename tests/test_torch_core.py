"""Port parity: the HiNM format core (`repro_torch.core`) against `repro.core`.

Masks and packing decide which weights survive, so they must be bit-equal
to the reference — on f32 and bf16 weights, V in {8, 32}, and weights with
deliberate ties (repeated magnitudes inside M-groups and tied column-vector
scores), where only a stable sort gives the reference's answer.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as _jpacking
from repro.core import sparsity as _jsparsity
from repro.core.types import HiNMConfig as JHiNMConfig
from repro_torch.core import packing, sparsity
from repro_torch.core.types import HiNMConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the reference functions under jit: one compile per shape instead of one
# per eager op keeps this file fast
jsparsity = types.SimpleNamespace(
    kept_column_ids=jax.jit(_jsparsity.kept_column_ids, static_argnums=1),
    vector_mask=jax.jit(_jsparsity.vector_mask, static_argnums=1),
    hinm_mask=jax.jit(_jsparsity.hinm_mask, static_argnums=1),
    nm_mask=jax.jit(_jsparsity.nm_mask, static_argnames=("n", "m", "axis")))
jpacking = types.SimpleNamespace(pack=jax.jit(_jpacking.pack, static_argnums=1),
                                 unpack=jax.jit(_jpacking.unpack),
                                 pack_mask=jax.jit(_jpacking.pack_mask))

CASES = [(dt, v, ties) for dt in ("float32", "bfloat16") for v in (8, 32)
         for ties in (False, True)]
IDS = [f"{dt}-V{v}-{'ties' if t else 'plain'}" for dt, v, t in CASES]


def _weights(v: int, ties: bool, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    if ties:
        # few magnitude levels -> repeated |w| inside M-groups, and
        # duplicated columns -> tied column-vector scores within a tile
        w = np.round(w * 2.0) / 2.0
        w[:, 1::6] = w[:, 0::6]
        w[:, 3::8] = -w[:, 2::8]
    return w


def _pair(w: np.ndarray, dtype: str):
    j = jnp.asarray(w).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(w).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return j, t


def _bits_j(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _bits_t(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _cfgs(v: int):
    return (JHiNMConfig(v=v, n=2, m=4, vector_sparsity=0.5),
            HiNMConfig(v=v, n=2, m=4, vector_sparsity=0.5))


@pytest.mark.parametrize("dtype,v,ties", CASES, ids=IDS)
def test_kept_column_ids_bit_equal(dtype, v, ties):
    jw, tw = _pair(_weights(v, ties), dtype)
    jc, tc = _cfgs(v)
    np.testing.assert_array_equal(
        np.asarray(jsparsity.kept_column_ids(jnp.abs(jw), jc)),
        sparsity.kept_column_ids(tw.abs(), tc).numpy())


@pytest.mark.parametrize("dtype,v,ties", CASES, ids=IDS)
def test_nm_mask_bit_equal(dtype, v, ties):
    jw, tw = _pair(_weights(v, ties, seed=1), dtype)
    for axis in (-1, 0):
        np.testing.assert_array_equal(
            np.asarray(jsparsity.nm_mask(jnp.abs(jw), n=2, m=4, axis=axis)),
            sparsity.nm_mask(tw.abs(), 2, 4, axis=axis).numpy())


@pytest.mark.parametrize("dtype,v,ties", CASES, ids=IDS)
def test_hinm_mask_bit_equal(dtype, v, ties):
    jw, tw = _pair(_weights(v, ties, seed=2), dtype)
    jc, tc = _cfgs(v)
    jm = np.asarray(jsparsity.hinm_mask(jnp.abs(jw), jc))
    tm = sparsity.hinm_mask(tw.abs(), tc).numpy()
    np.testing.assert_array_equal(jm, tm)
    np.testing.assert_array_equal(np.asarray(jsparsity.vector_mask(jnp.abs(jw), jc)),
                                  sparsity.vector_mask(tw.abs(), tc).numpy())


@pytest.mark.parametrize("dtype,v,ties", CASES, ids=IDS)
def test_pack_bit_equal(dtype, v, ties):
    jw, tw = _pair(_weights(v, ties, seed=3), dtype)
    jc, tc = _cfgs(v)
    jp, tp = jpacking.pack(jw, jc), packing.pack(tw, tc)
    np.testing.assert_array_equal(_bits_j(jp.vals), _bits_t(tp.vals))
    np.testing.assert_array_equal(np.asarray(jp.vec_idx), tp.vec_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jp.nm_idx), tp.nm_idx.numpy())
    assert tp.vec_idx.dtype == torch.int32 and tp.nm_idx.dtype == torch.int8
    assert (tp.n_out, tp.n_in, tp.k, tp.kn, tp.t) == (jp.n_out, jp.n_in, jp.k, jp.kn, jp.t)
    assert tp.packed_bytes() == jp.packed_bytes()
    assert tp.dense_bytes() == jp.dense_bytes()


@pytest.mark.parametrize("dtype,v,ties", CASES, ids=IDS)
def test_unpack_and_pack_mask_bit_equal(dtype, v, ties):
    jw, tw = _pair(_weights(v, ties, seed=4), dtype)
    jc, tc = _cfgs(v)
    jp, tp = jpacking.pack(jw, jc), packing.pack(tw, tc)
    np.testing.assert_array_equal(_bits_j(jpacking.unpack(jp)),
                                  _bits_t(packing.unpack(tp)))
    mask = packing.pack_mask(tp).numpy()
    np.testing.assert_array_equal(np.asarray(jpacking.pack_mask(jp)), mask)
    # the packed mask is the HiNM mask of the packing saliency
    np.testing.assert_array_equal(mask, sparsity.hinm_mask(tw.abs(), tc).numpy())


def test_hinm_config_validation_matches():
    for kw in (dict(v=12), dict(n=4, m=4), dict(vector_sparsity=1.0)):
        with pytest.raises(ValueError):
            JHiNMConfig(**kw)
        with pytest.raises(ValueError):
            HiNMConfig(**kw)
    for n_in in (4, 10, 48, 896, 4864):
        assert HiNMConfig().kept_columns(n_in) == JHiNMConfig().kept_columns(n_in)
