"""Bucket MinHash, the hand-written CUDA kernel's wrappers.

Replaces ``repro/kernels/minhash_buckets.py::minhash_even_buckets`` (the
TPU kernel ``_kernel``): K-fold MinHash signatures of buckets of data
ids, SILK's first step (paper §3.2) and the main cost of discovery. The
reference's main path does this work in jnp (``lsh.minhash_over_segments``);
the port runs it through this kernel on the card for the L seeding rounds.

Bound on this card: memory. Each id and offset is read once and each
signature written once in the int64 carrier (4 + 4 + 8 bytes a segment
of one id), the ids hashed K times in registers. Design
(``csrc/minhash_buckets.cu``): segments are given as CSR offsets rather
than equal-width rows, so the ragged buckets of an even partition with
t ∤ n need no padding, and the work follows the ids and the segments
together. Where segments hold more than ``SHORT_MAX`` ids on average
(even partitions: the dense fits, the LM cell's per-head fits), one warp
takes a segment. Otherwise (the code-space fits' signature partitions:
L·n segments, most of them empty) one lane takes a segment, and a
segment longer than ``SHORT_MAX`` is cut into jobs of at most ``CHUNK``
ids on a device work list, a warp a job, with no read on the host. The
reference's exact uint32 arithmetic keeps the signatures bit-identical.
The plain versions are ``ref.minhash_segments_ref`` and
``ref.minhash_even_buckets_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.utils.hashing import u32_as_i32

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]


#: the source instantiates its kernels for K = 1 .. MAX_K hashes per bucket
MAX_K = 8
#: a segment of at most this many ids is hashed by one lane; a layout
#: whose mean segment is longer takes a warp a segment
SHORT_MAX = 16
#: a longer segment's ids are cut into jobs of at most this many, a warp
#: a job
CHUNK = 1024
#: ints a slot of the work list holds (the source's SLOT: MAX_K minima,
#: jobs done, jobs in all)
SLOT_INTS = MAX_K + 2


@functools.cache
def _entry():
    lib = build.load("minhash_buckets")
    if lib.repro_minhash_slot_ints() != SLOT_INTS:
        raise RuntimeError("csrc/minhash_buckets.cu's SLOT differs from "
                           f"SLOT_INTS = {SLOT_INTS}")
    fn = lib.repro_minhash_segments_u32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def lane_layout(num_ids: int, num_segments: int,
                short_max: int | None = None) -> bool:
    """True when a lane takes a segment: the mean segment holds at most
    ``short_max`` (``SHORT_MAX``) ids, counted over all ``num_ids`` ids."""
    short_max = SHORT_MAX if short_max is None else short_max
    return num_ids <= short_max * num_segments


def work_sizes(num_ids: int, short_max: int | None = None,
               chunk: int | None = None) -> tuple[int, int, int]:
    """(max jobs, max slots, workspace ints) of the lane layout over
    ``num_ids`` ids: a segment longer than ``short_max`` gives
    ceil(size / ``chunk``) jobs, and a slot when that is more than one."""
    short_max = SHORT_MAX if short_max is None else short_max
    chunk = CHUNK if chunk is None else chunk
    if short_max < 0 or chunk < 1:
        raise ValueError(f"short_max={short_max}, chunk={chunk}")
    jobs = num_ids // chunk + num_ids // (short_max + 1) + 1
    slots = num_ids // (chunk + 1) + 1
    return jobs, slots, 4 + 4 * jobs + SLOT_INTS * slots


def minhash_segments(ids_flat: torch.Tensor, offsets: torch.Tensor,
                     keys: torch.Tensor) -> torch.Tensor:
    """Launch the kernel over CSR segments: (S,) signatures.

    ``ids_flat`` (P,) int32 ids; ``offsets`` (S+1,) int32, non-decreasing
    within [0, P] (segment s is ``ids_flat[offsets[s]:offsets[s+1]]``);
    ``keys`` (K, 2) uint32 (a, b) pairs in the int64 carrier. Returns the
    signatures in the int64 uint32 carrier, written so by the kernel, as
    the plain version returns them. Counts one launch in
    ``minhash_segments.launches`` a call.
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
    K, S, P = keys.shape[0], offsets.shape[0] - 1, ids_flat.shape[0]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside the kernel's 1..{MAX_K}")
    ids_c, offs_c = ids_flat.contiguous(), offsets.contiguous()
    keys_c = u32_as_i32(keys).contiguous()
    sig = torch.empty((S,), dtype=torch.int64, device=dev)
    if S == 0:
        return sig
    work, max_jobs = None, 0
    if lane_layout(P, S):
        max_jobs, _, ints = work_sizes(P)
        work = torch.empty((ints,), dtype=torch.int32, device=dev)
        work[:4].zero_()
    err = _entry()(ids_c.data_ptr(), offs_c.data_ptr(), S, keys_c.data_ptr(),
                   K, sig.data_ptr(), SHORT_MAX, CHUNK,
                   None if work is None else work.data_ptr(), max_jobs,
                   dev.index if dev.index is not None
                   else torch.cuda.current_device(),
                   torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "minhash_segments")
    minhash_segments.launches += 1
    return sig


minhash_segments.launches = 0


#: CSR layouts the kernel is held to its plain version on (``minhash_case``)
MINHASH_CASES = ("signature partition", "every segment empty",
                 "offsets[0] > 0", "one long segment among singletons",
                 "sizes at the thresholds", "sizes at the thresholds, no "
                 "empty segment", "even rows")


def minhash_case(case: str, rng: np.random.Generator
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(ids (P,) int32, offsets (S+1,) int32) of one of ``MINHASH_CASES``,
    drawn from ``rng``. Shared by the CPU and card tests, ``chip_smoke.py``
    and ``tools/kernel_variants.py``. "signature partition" is the
    code-space fits' layout: ``partition_by_signature`` of the MinHash
    signatures of seeded codes with many duplicate rows, over L·n
    segments, each table's tail empty (the lane layout). "sizes at the
    thresholds" holds segments of ``SHORT_MAX`` − 1, ``SHORT_MAX``,
    ``SHORT_MAX`` + 1 ids and about one, two and three ``CHUNK`` s of ids
    among empty segments and singletons (the lane layout); without the
    empty segments and singletons the warp layout takes them. "even
    rows" is the LM cell's fits' shape cut down (warp layout)."""
    if case not in MINHASH_CASES:
        raise ValueError(f"unknown MinHash case {case!r}")
    P_extra = 0
    if case == "signature partition":
        from repro_torch.core import lsh
        from repro_torch.core.buckets import partition_by_signature
        from repro_torch.core.silk import csr_offsets
        n, L = 4000, 20
        codes = rng.integers(0, 4, (n, 6))
        codes[n // 3:2 * n // 3] = codes[0]   # a bucket of > CHUNK rows
        keys = torch.from_numpy(rng.integers(
            0, 2**32, (L + 1, 3, 2), dtype=np.uint64).astype(np.int64))
        items = lsh.code_items(torch.from_numpy(codes.astype(np.int32)),
                               keys[L, 0])
        tables = partition_by_signature(lsh.minhash_signatures(
            items, None, keys[:L]))
        ids, seg = tables.flatten()
        offsets = csr_offsets(seg, tables.total_bucket_cap)
        return ids.numpy(), offsets.numpy()
    if case == "every segment empty":
        sizes = np.zeros(300, np.int64)
        P_extra = 50
    elif case == "offsets[0] > 0":
        sizes = rng.integers(0, 4, 500)
        P_extra = 37
    elif case == "one long segment among singletons":
        sizes = np.ones(3000, np.int64)
        sizes[1234] = 5 * CHUNK + 3
    elif case.startswith("sizes at the thresholds"):
        edge = [SHORT_MAX - 1, SHORT_MAX, SHORT_MAX + 1, CHUNK - 1, CHUNK,
                CHUNK + 1, 2 * CHUNK, 2 * CHUNK + 1, 3 * CHUNK - 1]
        sizes = np.array(edge * 3, np.int64)
        if case == "sizes at the thresholds":
            filler = rng.integers(0, 2, 100 * sizes.size)
            sizes = np.concatenate([sizes, filler])
        sizes = rng.permutation(sizes)
    else:
        sizes = np.full(96, 64, np.int64)
    start = 13 if case == "offsets[0] > 0" else 0
    offsets = start + np.concatenate([[0], np.cumsum(sizes)])
    ids = rng.integers(0, 2**31 - 1, int(offsets[-1]) + P_extra)
    return ids.astype(np.int32), offsets.astype(np.int32)


def minhash_even_buckets(ids: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's own signature: ids (nb, bsz) int32, keys (K, 2)
    -> (nb,) signatures, through the CSR kernel with equal-width rows."""
    if ids.ndim != 2:
        raise ValueError(f"ids must be (nb, bsz), got {tuple(ids.shape)}")
    nb, bsz = ids.shape
    offsets = (torch.arange(nb + 1, dtype=torch.int64, device=ids.device)
               * bsz).to(torch.int32)
    return minhash_segments(ids.reshape(-1), offsets, keys)
