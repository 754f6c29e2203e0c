"""The parts of `jax.random` the sampler uses, reproduced bit for bit in
integer torch ops.

JAX's default PRNG is threefry2x32 (`jax_default_prng_impl`), and its
random bits are drawn on the partitionable path
(`jax_threefry_partitionable`, the default since JAX 0.5): the bits of a
shape are ``threefry2x32(key, (hi, lo))`` over a 64-bit counter per
element (row-major iota, ``hi`` its upper and ``lo`` its lower 32 bits),
the two output words XORed.  Reproducing those bits lets the port's
sampled streams, its speculative "match" acceptance and a flight-recorder
replay be held token for token against the reference.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(JAX's raw key data).  Every word is held in int64 and masked to 32 bits
after each add, shift or rotate, so the same ops run on the CPU and on
CUDA (torch.uint32 lacks shifts on CUDA).  Nothing here holds state:
every function takes its keys and builds its tensors on their device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcastable int64 tensors of uint32 words: key (k1, k2), counter
    (x0, x1).  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + k1) & M32
    x1 = (x1 + k2) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` without 64-bit mode: the seed's low 32
    bits under a zero high word.  Returns an int64 (2,) key on `device`
    (the card unless the caller asks for the CPU, as every entry point)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: ``threefry2x32(key, (0, uint32(data)))``,
    broadcast over a batch.  key (..., 2); data an int or an integer
    tensor broadcastable against ``key[..., 0]`` on its device (negative
    values wrap to uint32 as `jnp.uint32` wraps them)."""
    if isinstance(data, int):      # a fill, not a host-to-device copy
        d = torch.full_like(key[..., 0], data & M32)
    else:
        d = data.to(torch.int64) & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words of shape ``(..., n)``, one row of n per key
    (keys (..., 2)): JAX's partitionable `random_bits` of shape ``(n,)``.
    For n < 2**32 the counter's high word is 0 and its low word the
    element index."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], torch.zeros_like(idx),
                          idx)
    return b1 ^ b2


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """`jax.random.uniform`'s float construction: the top 23 bits as the
    mantissa of a float32 in [1, 2), minus 1.  Returns float32 in [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(keys: torch.Tensor, n: int | None = None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32, per key: shape ``(..., n)``, or one
    value per key (shape ``()`` in JAX: counter 0) when n is None.  Scaled
    as ``max(minval, u * (maxval - minval) + minval)`` in float32."""
    bits = random_bits(keys, 1 if n is None else n)
    if n is None:
        bits = bits[..., 0]
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo                      # in float32, as JAX
    return torch.clamp(bits_to_unit(bits) * float(scale) + float(lo), min=float(lo))


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.gumbel` (mode "low"), float32 (..., n): ``-log(-log(u))``
    with u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n, minval=_F32_TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical` per row (the Gumbel-max trick JAX takes):
    keys (..., 2), logits (..., V) float32 -> argmax(logits + gumbel)
    (..., ) int64, the first maximum on ties as `jnp.argmax`."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
