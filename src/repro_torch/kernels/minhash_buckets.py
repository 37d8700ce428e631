"""Bucket MinHash, the hand-written CUDA kernel's wrappers.

Replaces ``repro/kernels/minhash_buckets.py::minhash_even_buckets`` (the
TPU kernel ``_kernel``): K-fold MinHash signatures of buckets of data
ids, SILK's first step (paper §3.2) and the main cost of discovery. The
reference's main path does this work in jnp (``lsh.minhash_over_segments``);
the port runs it through this kernel on the card for the L seeding rounds.

Bound on this card: memory. Each id is read once and hashed K times in
registers, so HBM traffic is 4 bytes per id (160 MB per SILK round at
1M × 40 tables). Design (``csrc/minhash_buckets.cu``): segments are given
as CSR offsets rather than equal-width rows, so the ragged buckets of an
even partition with t ∤ n need no padding; one warp per segment,
coalesced strided loads with eight in flight per lane, K minima in
registers, a warp min-reduce, and the reference's exact uint32
arithmetic, so signatures are bit-identical. The plain versions are
``ref.minhash_segments_ref`` and ``ref.minhash_even_buckets_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.utils.hashing import M32, u32_as_i32

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


#: the source instantiates its kernel for K = 1 .. MAX_K hashes per bucket
MAX_K = 8


def _entry():
    fn = build.load("minhash_buckets").repro_minhash_segments_u32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def minhash_segments(ids_flat: torch.Tensor, offsets: torch.Tensor,
                     keys: torch.Tensor) -> torch.Tensor:
    """Launch the kernel over CSR segments: (S,) signatures.

    ``ids_flat`` (P,) int32 ids; ``offsets`` (S+1,) int32, non-decreasing
    within [0, P] (segment s is ``ids_flat[offsets[s]:offsets[s+1]]``);
    ``keys`` (K, 2) uint32 (a, b) pairs in the int64 carrier. Returns the
    signatures in the int64 uint32 carrier, as the plain version does.
    Counts one launch in ``minhash_segments.launches``.
    """
    dev = ids_flat.device
    if dev.type != "cuda":
        raise ValueError(f"minhash_segments runs on CUDA tensors, got {dev}")
    if offsets.device != dev or keys.device != dev:
        raise ValueError("ids_flat, offsets and keys must share a device")
    if ids_flat.ndim != 1 or offsets.ndim != 1 or offsets.shape[0] < 1:
        raise ValueError("expected ids_flat (P,) and offsets (S+1,)")
    if ids_flat.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError("ids_flat and offsets must be int32")
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (K, 2), got {tuple(keys.shape)}")
    K, S = keys.shape[0], offsets.shape[0] - 1
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside the kernel's 1..{MAX_K}")
    ids_c, offs_c = ids_flat.contiguous(), offsets.contiguous()
    keys_c = u32_as_i32(keys).contiguous()
    sig = torch.empty((S,), dtype=torch.int32, device=dev)
    if S > 0:
        err = _entry()(ids_c.data_ptr(), offs_c.data_ptr(), S, keys_c.data_ptr(), K,
                 sig.data_ptr(), dev.index if dev.index is not None
                 else torch.cuda.current_device(),
                 torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "minhash_segments")
        minhash_segments.launches += 1
    return sig.to(torch.int64) & M32


minhash_segments.launches = 0


def minhash_even_buckets(ids: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's own signature: ids (nb, bsz) int32, keys (K, 2)
    -> (nb,) signatures, through the CSR kernel with equal-width rows."""
    if ids.ndim != 2:
        raise ValueError(f"ids must be (nb, bsz), got {tuple(ids.shape)}")
    nb, bsz = ids.shape
    offsets = (torch.arange(nb + 1, dtype=torch.int64, device=ids.device)
               * bsz).to(torch.int32)
    return minhash_segments(ids.reshape(-1), offsets, keys)
