"""32-bit universal hashing primitives used by MinHash / SILK.

The counterpart of ``repro.utils.hashing``. PyTorch on the CPU has no
uint32 add, shift or min, so every uint32 value here travels in an
int64 tensor holding a value in [0, 2**32): each ``*`` and ``+`` is
followed by ``& M32``. The int64 product may wrap, but its low 32 bits
are the uint32 product's, and since every carried value is
non-negative, sort and min keep unsigned order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
UMAX32 = M32


def u32_as_i32(t: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64 carrier, or int32 bits) as int32 tensors with
    the same bit patterns: what a CUDA kernel reads as ``uint32_t``.

    Done by arithmetic, not ``.view``: a carried word >= 2**31 becomes
    the negative int32 with its bits, on every device.
    """
    if t.dtype == torch.int32:
        return t
    t = t.to(torch.int64) & M32
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def derive_hash_keys(gen: torch.Generator, shape: tuple[int, ...]
                     ) -> torch.Tensor:
    """Draw (..., 2) uint32 (a, b) multiply-add keys; ``a`` is forced odd.

    Drawn from ``gen`` on its device; returned in the int64 carrier.
    """
    bits = torch.randint(0, 1 << 32, tuple(shape) + (2,), generator=gen,
                         device=gen.device, dtype=torch.int64)
    bits[..., 0] |= 1
    return bits


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under the
    key (k0, k1); every value a uint32 in the int64 carrier."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _raw_key(key) -> tuple[int, int]:
    """The two uint32 words of a raw (2,) JAX key (tensor, numpy, list)."""
    kt = (key if isinstance(key, torch.Tensor)
          else torch.from_numpy(np.asarray(key).astype(np.int64))).reshape(-1)
    if kt.numel() != 2:
        raise ValueError(f"expected a raw (2,) uint32 key, got {kt.numel()} "
                         "words")
    k0, k1 = (int(v) & M32 for v in kt.tolist())
    return k0, k1


def split(key, num: int = 2) -> torch.Tensor:
    """(num, 2) raw keys in the int64 carrier: the exact bits of
    ``jax.random.split(key, num)`` under the partitionable Threefry-2x32
    of jax 0.9, where key i is the hashed pair of the counter (0, i)
    (both words, not their xor). ``key`` as in
    ``derive_hash_keys_from_key``; the result is on the CPU."""
    k0, k1 = _raw_key(key)
    idx = torch.arange(num, dtype=torch.int64)
    x0, x1 = _threefry2x32(k0, k1, idx >> 32, idx & M32)
    return torch.stack([x0, x1], dim=-1)


def derive_hash_keys_from_key(key, shape: tuple[int, ...]) -> torch.Tensor:
    """(..., 2) uint32 (a | 1, b) keys derived from a raw JAX key: the
    exact bits of ``repro.utils.hashing.derive_hash_keys(key, shape)``.

    ``key`` is the raw (2,) uint32 key data (int64 carrier, or any
    integer array; a typed key's ``jax.random.key_data``). This
    reproduces ``jax.random.bits(key, shape + (2,), uint32)`` under the
    partitionable Threefry-2x32 that jax 0.9 uses by default
    (``jax_threefry_partitionable``): the counter of element i is its
    flat index as (hi, lo) 32-bit words, and the bits are x0 ^ x1 of
    the hashed pair. The result is in the int64 carrier, on ``key``'s
    device (the CPU for a non-tensor key).
    """
    k0, k1 = _raw_key(key)
    count = 2 * math.prod(shape)
    dev = key.device if isinstance(key, torch.Tensor) else None
    idx = torch.arange(count, dtype=torch.int64, device=dev)
    x0, x1 = _threefry2x32(k0, k1, idx >> 32, idx & M32)
    bits = (x0 ^ x1).reshape(tuple(shape) + (2,))
    bits[..., 0] |= 1
    return bits


def hash_u32(x: torch.Tensor, a, b) -> torch.Tensor:
    """Multiply-add + murmur3-style finalizer, as ``repro``'s ``hash_u32``.

    ``x`` may be int32 ids (reinterpreted as uint32) or carried uint32.
    """
    h = ((x.to(torch.int64) & M32) * a + b) & M32
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & M32
    h = h ^ (h >> 16)
    return h


def mix_u32(acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fold ``v`` into running signature ``acc`` (boost-style combine)."""
    acc = acc.to(torch.int64) & M32
    v = v.to(torch.int64) & M32
    return ((acc * 0x01000193) ^ (v + 0x9E3779B9 + (acc << 6) + (acc >> 2))) & M32


def combine2_u32(x: torch.Tensor, y: torch.Tensor, a, b) -> torch.Tensor:
    """Hash a pair (x, y) into uint32, as ``repro``'s ``combine2_u32``."""
    return hash_u32(hash_u32(x, a, b) ^ (y.to(torch.int64) & M32),
                    a ^ 0x5851F42D, b)


def run_starts(*sorted_keys: torch.Tensor,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean start-of-run markers over jointly sorted key arrays.

    A run is a maximal block of equal (key_0, ..., key_m) tuples. Invalid
    entries (sorted to the end by the caller) never start a run.
    """
    neq = None
    for k in sorted_keys:
        d = torch.ones_like(k, dtype=torch.bool)
        d[1:] = k[1:] != k[:-1]
        neq = d if neq is None else (neq | d)
    if valid is not None:
        prev_valid = torch.zeros_like(valid)
        prev_valid[1:] = valid[:-1]
        neq = (neq | ~prev_valid) & valid
    return neq
