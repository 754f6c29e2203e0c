"""Port parity: kernel dispatch (`repro_torch.kernels.ops`) against the JAX
package's Pallas kernels run in interpret mode, plus the port's dispatch
and import rules.

On the CPU the port's `ops` take the plain versions (a CPU tensor never
reaches a CUDA kernel); the kernels themselves are held against the same
plain versions on the card by `chip_smoke.py`.
"""
import functools
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import HiNMConfig as JHiNMConfig
from repro.core.types import PackedHiNM as JPackedHiNM
from repro.kernels import ops as jops
from repro.models import paging as jpaging
from repro_torch.convert import to_tensor
from repro_torch.core import packing
from repro_torch.core.types import HiNMConfig, PackedHiNM
from repro_torch.kernels import hinm_spmm as hs
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as pa

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (n_out, n_in, batch, V) — the sweep of tests/test_kernels.py
SHAPES = [(16, 16, 4, 8), (64, 48, 10, 8), (32, 64, 33, 16), (128, 96, 7, 32),
          (64, 128, 129, 8)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _to_jax_packed(p: PackedHiNM):
    """The same packed numbers as a reference PackedHiNM (packing itself is
    held bit-equal to the reference in test_torch_core.py)."""
    c = p.config
    jdt = jnp.bfloat16 if p.vals.dtype == torch.bfloat16 else jnp.float32
    return JPackedHiNM(jnp.asarray(p.vals.float().numpy()).astype(jdt),
                       jnp.asarray(p.vec_idx.numpy()), jnp.asarray(p.nm_idx.numpy()),
                       p.n_out, p.n_in, JHiNMConfig(c.v, c.n, c.m, c.vector_sparsity))


@functools.lru_cache(maxsize=None)
def _spmm_case(n_out, n_in, b, v, dtype):
    """Shared inputs + the JAX interpret-mode result for one sweep point."""
    rng = np.random.default_rng(n_out * 1000 + n_in + b)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    w = torch.from_numpy(rng.normal(size=(n_out, n_in)).astype(np.float32)).to(tdt)
    x = torch.from_numpy(rng.normal(size=(b, n_in)).astype(np.float32)).to(tdt)
    p = packing.pack(w, HiNMConfig(v=v, n=2, m=4, vector_sparsity=0.5))
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == "bfloat16"
                                                 else jnp.float32)
    y = jops.hinm_matmul(jx, _to_jax_packed(p), backend="interpret")
    return x, p, np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("backend", ["auto", "oracle"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_out,n_in,b,v", SHAPES)
def test_hinm_matmul_matches_pallas(n_out, n_in, b, v, dtype, backend):
    x, p, y_ref = _spmm_case(n_out, n_in, b, v, dtype)
    y = ops.hinm_matmul(x, p, backend=backend)
    assert y.dtype == x.dtype and y.shape == (b, n_out)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=tol, atol=tol * 10)


def test_hinm_matmul_leading_dims_and_chunked_gather():
    x, p, y_ref = _spmm_case(64, 48, 10, 8, "float32")
    y = ops.hinm_matmul(x.reshape(2, 5, 48), p)
    assert y.shape == (2, 5, 64)
    np.testing.assert_allclose(y.reshape(10, 64).numpy(), y_ref, rtol=1e-5, atol=1e-4)
    # > 1024 rows: the tile-chunked gather path equals the oracle
    xb = torch.randn((1100, 48), generator=torch.Generator().manual_seed(0))
    y1 = hs.hinm_spmm_ref(xb, p, chunk_bytes=4096)
    np.testing.assert_allclose(y1.numpy(), hs.hinm_spmm_oracle(xb, p).numpy(),
                               rtol=2e-5, atol=2e-5)


def _paged_case(b, s, kvh, g, hd, page, n_bt, n_pages, dtype, sweep=2, seed=0):
    """Random page allocation per slot, random live rows, `sweep` interior
    rows reset to the kpos sentinel, q at the slot's next `s` positions
    (the generator of tests/test_paged_attn.py)."""
    rng = np.random.default_rng(seed)
    pool_shape = (n_pages, page, kvh, hd)
    kp = rng.normal(size=pool_shape)
    vp = rng.normal(size=pool_shape)
    kpos = np.full((n_pages, page), jpaging.KPOS_SENTINEL, np.int32)
    bt = np.full((b, n_bt), jpaging.SENTINEL_PAGE, np.int32)
    free = list(range(jpaging.N_RESERVED, n_pages))
    rng.shuffle(free)
    positions = []
    for bi in range(b):
        n_alloc = int(rng.integers(1, n_bt + 1))
        pages = [free.pop() for _ in range(n_alloc)]
        bt[bi, :n_alloc] = pages
        live = int(rng.integers(1, n_alloc * page + 1))
        for r in range(live):
            kpos[pages[r // page], r % page] = r
        for r in rng.choice(live, size=min(sweep, live), replace=False):
            if r != live - 1:
                kpos[pages[r // page], r % page] = jpaging.KPOS_SENTINEL
        positions.append([live - 1 + i for i in range(s)])
    q = rng.normal(size=(b, s, kvh * g, hd))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(kpos), jnp.asarray(bt), jnp.asarray(positions, jnp.int32))
    targs = tuple(to_tensor(np.asarray(a), "cpu") for a in jargs)
    return jargs, targs


CASES = [
    # b  s kvh g  hd page n_bt n_pages window dtype   tol
    (3, 1, 2, 2, 32, 8, 4, 16, 0, "float32", 5e-6),    # GQA decode
    (2, 1, 4, 1, 16, 4, 8, 40, 0, "float32", 5e-6),    # MHA, many pages
    (3, 1, 2, 2, 32, 8, 4, 16, 16, "float32", 5e-6),   # sliding window
    (2, 3, 2, 2, 32, 8, 4, 16, 0, "float32", 5e-6),    # spec verify s=3
    (2, 4, 2, 2, 16, 16, 2, 8, 0, "float32", 5e-6),    # s=4, page=16
    (3, 1, 2, 4, 64, 16, 4, 16, 0, "bfloat16", 5e-2),  # bf16 pool
    (1, 1, 2, 2, 32, 8, 1, 4, 0, "float32", 5e-6),     # single page
]


@pytest.mark.parametrize("b,s,kvh,g,hd,page,n_bt,n_pages,window,dtype,tol", CASES)
def test_paged_attention_matches_pallas(b, s, kvh, g, hd, page, n_bt, n_pages,
                                        window, dtype, tol):
    jargs, targs = _paged_case(b, s, kvh, g, hd, page, n_bt, n_pages, dtype)
    ref = jops.paged_attention(*jargs, window=window, backend="interpret")
    out = ops.paged_attention(*targs, window=window)
    assert out.dtype == targs[0].dtype and out.shape == targs[0].shape
    err = np.abs(out.float().numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err < tol, err


def test_paged_attention_sentinel_heavy():
    """Only each slot's newest row survives: attention reduces to that
    row's V, every other row masked through the kpos sentinel."""
    jargs, _ = _paged_case(2, 1, 2, 2, 32, 8, 4, 16, "float32", seed=3)
    kpos = np.asarray(jargs[3]).copy()
    bt = np.asarray(jargs[4])
    q_pos = np.asarray(jargs[5])
    for bi in range(2):
        for r in range(int(q_pos[bi, 0])):
            kpos[bt[bi, r // 8], r % 8] = jpaging.KPOS_SENTINEL
    jargs = jargs[:3] + (jnp.asarray(kpos),) + jargs[4:]
    targs = tuple(to_tensor(np.asarray(a), "cpu") for a in jargs)
    ref = np.asarray(jops.paged_attention(*jargs, backend="interpret"))
    out = ops.paged_attention(*targs).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-6)
    vp = np.asarray(jargs[2])
    for bi in range(2):
        newest = int(q_pos[bi, 0])
        want = vp[bt[bi, newest // 8], newest % 8]             # (KV, hd)
        got = out[bi, 0].reshape(2, 2, 32)                      # (KV, G, hd)
        np.testing.assert_allclose(got, np.broadcast_to(want[:, None], got.shape),
                                   atol=5e-6)


def test_cpu_dispatch_never_launches_and_cuda_backend_raises():
    hs.hinm_spmm.launches = 0
    pa.paged_decode_attn.launches = 0
    x, p, _ = _spmm_case(16, 16, 4, 8, "float32")
    _, targs = _paged_case(3, 1, 2, 2, 32, 8, 4, 16, "float32")
    for backend in ("auto", "torch"):
        ops.hinm_matmul(x, p, backend=backend)
        ops.paged_attention(*targs, backend=backend)
    assert hs.hinm_spmm.launches == 0 and pa.paged_decode_attn.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.hinm_matmul(x, p, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.paged_attention(*targs, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.hinm_matmul(x, p, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.paged_attention(*targs, backend="off")
    assert hs.hinm_spmm.launches == 0 and pa.paged_decode_attn.launches == 0


def test_hinm_spmm_variant_override_is_checked_before_launch():
    x, p, _ = _spmm_case(16, 16, 4, 8, "float32")
    hs.hinm_spmm.launches = 0
    with pytest.raises(ValueError, match="unknown variant"):
        hs.hinm_spmm(x, p, variant="tiles")
    with pytest.raises(ValueError, match="CUDA tensors"):
        hs.hinm_spmm(x, p, variant="mma")
    assert hs.hinm_spmm.launches == 0 and hs.VARIANTS == ("rows", "mma")


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro(\.|\s+import\b))",
    re.M)


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    assert FORBIDDEN.search("import jax.numpy as jnp") and FORBIDDEN.search(
        "from repro.core import packing") and not FORBIDDEN.search("import repro_torch")


def test_port_import_leaves_jax_and_repro_unloaded():
    code = ("import sys, repro_torch.serve, repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.kernels.nm_select, repro_torch.train.pruning, repro_torch.perm, "
            "repro_torch.core.api, repro_torch.core.baselines, repro_torch.core.gyro, "
            "repro_torch.core.hungarian, repro_torch.core.saliency\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
