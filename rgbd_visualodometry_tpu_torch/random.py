"""Counter-based threefry2x32 keys, bit-identical to ``jax.random``.

The JAX package draws its RANSAC samples with ``jax.random.split`` and
``jax.random.uniform`` (``mapstate.py:156``, ``frontend.py:288``,
``pnp.py:104-118``) under jax's threefry2x32 generator with
``jax_threefry_partitionable=True``, and ``MultiStreamVO`` derives each
stream's key with ``jax.random.fold_in`` (``parallel/mesh.py:71-73``).  This
module reproduces those four functions on torch tensors, so the port draws
exactly the same hypotheses from the same key and a JAX state carried into
the port keeps its stream.
``torch.Generator`` is a different stream and is not used.

A key is an int64 tensor ``[2]`` holding two uint32 words.  torch's
``uint32`` lacks shifts and adds on the CPU, so every word lives in int64
and is masked with ``& 0xFFFFFFFF`` after each add and shift.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) on int64-held uint32 words;
    ``k1``/``k2`` are 0-d, ``x1``/``x2`` any matching shape."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words ``(0, seed)``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``: the hash of
    the words ``(0, data)`` under ``key``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], zero, zero + (int(data) & _MASK))
    return torch.stack([b1, b2])


def _counters(n: int, device):
    # iota_2x32_shape: a uint64 iota split in (high, low) words
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return lo >> 32, lo & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``[num, 2]`` keys."""
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits32(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit), as int64-held words."""
    n = 1
    for s in shape:
        n *= int(s)
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on ``[0, 1)``: the top
    23 bits become the mantissa m of a float in ``[1, 2)``, minus one -
    exactly ``m * 2**-23``, which is computed so (a dtype view has no vmap
    rule in every torch release)."""
    mantissa = random_bits32(key, shape) >> 9
    return mantissa.to(torch.float32) * 2.0**-23
