"""Threefry-2x32 keys, bits and categorical draws in torch ops.

The torch counterpart of what ``jax.random`` computes inside the
reference sampler (``repro/serve/sampling.py``, ``_jit_sample``), so a
sampled stream of the port draws the reference's own keys: a key is a pair
of uint32 words; :func:`prng_key` is ``jax.random.PRNGKey``, :func:`fold_in`
is ``jax.random.fold_in``, :func:`random_bits` the 32-bit draw of a key
under ``jax_threefry_partitionable`` (element ``i`` of a draw is ``x0 ^
x1`` of the block cipher applied to the counter pair ``(i >> 32, i &
0xFFFFFFFF)``), :func:`uniform` and :func:`gumbel` the float draws built
on it, and :func:`categorical` the index of the largest ``gumbel +
logits``.

torch has few uint32 operations, so a word is held in an int64 tensor
with values in ``[0, 2**32)`` and every sum and shift is masked back to 32
bits.  Every function works on tensors of any device and takes batches of
keys: a key is a pair ``(k0, k1)`` of int64 tensors of one shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: fp32's smallest normal number, ``jnp.finfo(jnp.float32).tiny``
_TINY = torch.finfo(torch.float32).tiny

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` under ``key``; every operand broadcasts."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed &
    0xFFFFFFFF)``."""
    seed = int(seed)
    return (torch.tensor((seed >> 32) & _M32, dtype=torch.int64,
                         device=device),
            torch.tensor(seed & _M32, dtype=torch.int64, device=device))


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in(key, data)`` for uint32 ``data`` held in int64
    (broadcast against the key's words): the cipher of ``(0, data)``."""
    return threefry2x32(key, torch.zeros_like(data), data & _M32)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """32-bit draws ``(..., n)`` of each key of the batch ``(...)``, as
    ``jax.random.bits`` gives them under partitionable threefry."""
    k0, k1 = key
    i = torch.arange(n, dtype=torch.int64, device=k0.device)
    x0, x1 = threefry2x32((k0[..., None], k1[..., None]), i >> 32, i & _M32)
    return x0 ^ x1


def uniform(key: Key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """fp32 draws in ``[minval, maxval)``, as ``jax.random.uniform``: the
    top 23 bits as a mantissa of ``[1, 2)``, minus 1, scaled and shifted
    in fp32, and clamped below at ``minval``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.clamp_min(floats * span + lo, lo.item())


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ("low") mode: ``-log(-log u)``
    of a uniform draw in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of fp32 ``logits``
    ``(..., V)``, one key a row: the first index of the largest ``gumbel +
    logits``."""
    return (gumbel(key, logits.shape[-1]) + logits).argmax(dim=-1)
