"""Threefry-2x32 keys and draws, bit for bit those of ``jax.random``.

The serving engine samples with one PRNG key per slot, split once per
emitted token, and ``verify_accept`` replays that schedule so a speculative
tick emits exactly what the one-token path would (``veomni_tpu/models/
decode.py:532``, ``:675``). A ``torch.Generator`` per slot can neither be
batched nor replayed, so this module ports what the reference calls:
``jax.random.PRNGKey`` (``threefry_seed``), ``jax.random.split``, and
``jax.random.categorical``'s Gumbel-max draw (``mode="low"``) over
``random_bits``, all with ``jax_threefry_partitionable`` on (the default of
the JAX version the reference pins): a key is a pair of 32-bit words, the
counter of element ``i`` of a draw is the 64-bit pair ``(0, i)``, and the
bits of a 32-bit draw are the two hash words xored.

Keys are int64 tensors ``[..., 2]`` holding the unsigned 32-bit words;
every operation masks back to 32 bits, so the integer ops run on any
device. The Gumbel noise ``-log(-log(u))`` is computed in f32 with torch's
``log``, which may differ from XLA's in the last place: the uniforms are
bit-exact, the draws equal except at a near tie of ``logits + noise``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters (x1, x2) under key
    (k1, k2); all int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s words as a host uint32 [2] array: a
    32-bit seed is padded with a zero high word, a wider one split."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & MASK
    return np.array([hi, seed & MASK], np.uint32)


def as_keys(keys, device=None) -> torch.Tensor:
    """Host uint32 key words (numpy) or a key tensor -> int64 tensor."""
    if isinstance(keys, np.ndarray):
        keys = torch.from_numpy(keys.astype(np.int64))
    return keys.to(device=device, dtype=torch.int64)


def split(keys, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key: [..., 2] -> [..., num, 2]."""
    keys = as_keys(keys)
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[..., :1], keys[..., 1:], torch.zeros_like(counts), counts)
    return torch.stack([a, b], dim=-1)


def random_bits(keys, n: int) -> torch.Tensor:
    """32-bit random words [..., n] of each key [..., 2] (``random_bits``)."""
    keys = as_keys(keys)
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[..., :1], keys[..., 1:], torch.zeros_like(counts), counts)
    return a ^ b


def uniform_low(keys, n: int) -> torch.Tensor:
    """f32 uniforms in [tiny, 1) (``_uniform`` with minval=tiny, maxval=1):
    the top 23 bits of each word as the mantissa of a float in [1, 2),
    minus 1, plus tiny, floored at tiny."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats + _TINY, _TINY)


def gumbel(keys, n: int) -> torch.Tensor:
    """Standard Gumbel noise [..., n] (``jax.random.gumbel``, mode "low")."""
    return -torch.log(-torch.log(uniform_low(keys, n)))


def categorical(keys, logits) -> torch.Tensor:
    """One draw per row of logits [S,V] f32 -> [S] int64, the Gumbel-max
    trick of ``jax.random.categorical`` (first index on ties). keys [S,2]
    draws each row with its own key; one key [2] draws the whole [S,V] (as
    ``jax.random.categorical(key, logits)``). The keys must lie on the
    logits' device: the hash runs over every logit."""
    if not isinstance(keys, torch.Tensor) or keys.device != logits.device:
        where = keys.device if isinstance(keys, torch.Tensor) else "the host"
        raise ValueError(f"categorical: keys on {where}, logits on {logits.device}")
    if keys.dim() == 1:
        noise = gumbel(keys, logits.numel()).view(logits.shape)
    else:
        noise = gumbel(keys, logits.shape[-1])
    return torch.argmax(noise + logits, dim=-1)
