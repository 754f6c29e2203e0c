"""Port parity: K3 `nm_select` (`repro_torch.kernels.nm_select`,
`ops.nm_apply`) against the JAX package's Pallas kernel in interpret mode
and its argsort oracle `ref.nm_select_ref`.

On the CPU the port takes its plain version, which must be bit-equal to
both (compared as integer bit patterns, so -0.0 and +0.0 differ); the CUDA
kernel is held bit for bit against the same plain version on the card by
`chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.nm_select import nm_select as jnm_select
from repro_torch.convert import to_tensor
from repro_torch.kernels import nm_select as nms
from repro_torch.kernels import ops

# the argsort oracle under jit: one compile per case instead of one per op
j_oracle = jax.jit(jref.nm_select_ref, static_argnums=(1, 2))
# the sweep of tests/test_kernels.py::test_nm_select_sweep
SHAPES = [(8, 16), (32, 64), (7, 12), (128, 512)]
NM = [(2, 4), (1, 4), (1, 2)]


def _weights(shape, dtype, seed=0):
    """Normal weights whose first rows are exact ties: all equal, +0.0
    against -0.0, and x against -x; as a JAX array and the same bits as a
    torch tensor."""
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    cols = np.arange(shape[-1])
    w[..., 0, :] = 0.75
    w[..., 1, :] = np.where(cols % 3 == 0, -0.0, 0.0)
    w[..., 2, :] = np.where(cols % 2 == 0, 1.5, -1.5)
    jw = jnp.asarray(w).astype(dtype)
    return jw, to_tensor(np.asarray(jw), "cpu")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nn,mm", NM)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bit_equal_to_pallas_and_oracle(shape, nn, mm, dtype):
    jw, w = _weights(shape, getattr(jnp, dtype))
    got = _bits(nms.nm_select_ref(w, nn, mm).view(
        torch.int16 if dtype == "bfloat16" else torch.int32).numpy())
    np.testing.assert_array_equal(got, _bits(j_oracle(jw, nn, mm)))
    if dtype == "float32" or nn == 2:
        np.testing.assert_array_equal(
            got, _bits(jnm_select(jw, nn=nn, mm=mm, interpret=True)))


def test_ties_go_to_the_lower_index_and_keep_their_sign():
    w = torch.tensor([[1.0, 1.0, 1.0, 1.0], [-0.0, 0.0, -0.0, 0.0], [2.0, -2.0, 2.0, -2.0]])
    out = ops.nm_apply(w)
    assert out.tolist() == [[1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0], [2.0, -2.0, 0.0, 0.0]]
    assert torch.signbit(out[1]).tolist() == [True, False, False, False]
    assert torch.signbit(out[2]).tolist() == [False, True, False, False]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nm_apply_leading_dims(dtype):
    jw, w = _weights((3, 8, 64), getattr(jnp, dtype), seed=1)
    want = jops.nm_apply(jw, 2, 4, backend="interpret")
    got = ops.nm_apply(w, 2, 4)
    assert got.shape == w.shape
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    np.testing.assert_array_equal(got.view(bits).numpy(), _bits(want))
    np.testing.assert_array_equal(ops.nm_apply(w, 2, 4, backend="torch").view(bits).numpy(),
                                  _bits(want))


def test_cols_not_divisible_by_m_raise():
    with pytest.raises(ValueError, match="% M=4"):
        ops.nm_apply(torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="% M=4"):
        nms.nm_select_ref(torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="% M=4"):
        jnm_select(jnp.zeros((4, 6)), interpret=True)


def test_cpu_dispatch_never_launches_and_cuda_backend_raises():
    nms.nm_select.launches = 0
    w = torch.randn((8, 16))
    for backend in ("auto", "torch"):
        ops.nm_apply(w, backend=backend)
    assert nms.nm_select.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.nm_apply(w, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.nm_apply(w, backend="pallas")
    assert nms.nm_select.launches == 0
