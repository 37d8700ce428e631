"""Hamming distance + argmin, the hand-written CUDA kernels' wrappers.

Replace ``repro/kernels/distance_argmin.py::distance_argmin_hamming``
(the TPU kernel ``_ham_kernel``, attribute equality over int32 codes) and
``::distance_argmin_hamming_packed`` (``_ham_packed_kernel``, XOR + field
test + popcount over bit-packed uint32 words): GEEK's one-pass
assignment for hetero rows with categorical columns (equality) and for
sparse sets and numeric-only hetero rows (packed, 16- and 4-bit fields).

Bound on this card: operations, not memory: 32-bit integer compares,
adds and a running minimum (equality), and for the packed form the
logic, adds and ``__popc`` of each word pair, which Hopper issues on
three pipes. Design (``csrc/distance_argmin_hamming.cu``): for rows of
at most 32 codes (the main path's 9) the equality kernel is templated on
the exact width, so a row compares only its own columns; each thread
keeps 4 rows and one shared-memory load of a center serves them; a
center's count and index form one key (count · 32 + its index in its
tile of 32), so a tile's minimum is one min a pair, merged across tiles
with a strict '<' (``ref.distance_argmin_hamming_keys`` is that
arithmetic in plain torch). Wider equality rows and the packed form walk
every center in ascending order, one row a thread, from shared-memory
tiles, with a strict '<' so ties go to the lowest index; the packed
form tests all fields of a word at once with the SWAR test
``(((z & low) + low) | z) & high`` (``pack.field_mismatch_swar``): 4
integer ops a word where the reference's OR-fold takes 11. The contract
is the reference's main path (``core.assign.assign_hamming`` and
``assign_hamming_packed``): an invalid center counts ``d + 1`` (packed
without ``d``: int32 max), so labels and counts equal the plain versions
``ref.distance_argmin_hamming_ref`` and
``ref.distance_argmin_hamming_packed_ref`` bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pack import SUPPORTED_BITS

INT32_MAX = 2**31 - 1

_EQ_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
_PK_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _entry(name: str, argtypes):
    fn = getattr(build.load("distance_argmin_hamming"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _check(x: torch.Tensor, centers: torch.Tensor,
           center_valid: torch.Tensor, what: str) -> torch.device:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")
    if centers.device != dev or center_valid.device != dev:
        raise ValueError(f"{what}: inputs, centers and center_valid must "
                         "share a device")
    if x.ndim != 2 or centers.ndim != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"{what}: expected (n, d) and (k, d), got "
                         f"{tuple(x.shape)} and {tuple(centers.shape)}")
    k = centers.shape[0]
    if tuple(center_valid.shape) != (k,):
        raise ValueError(f"{what}: center_valid must be ({k},)")
    if k == 0 or x.shape[1] == 0:
        raise ValueError(f"{what}: need at least one center and one column")
    if x.shape[0] >= 2**31 or k >= 2**31:
        raise ValueError(f"{what}: n and k must fit in int32")
    return dev


def _stream(dev: torch.device):
    return (dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def distance_argmin_hamming(codes: torch.Tensor, centers: torch.Tensor,
                            center_valid: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the equality kernel: (labels (n,) int32, counts (n,) int32).

    ``codes`` (n, d) and ``centers`` (k, d) are integer codes (cast to
    int32 here), ``center_valid`` (k,) bool, all on one CUDA device.
    Counts one launch in ``distance_argmin_hamming.launches``.
    """
    dev = _check(codes, centers, center_valid, "distance_argmin_hamming")
    for t in (codes, centers):
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise TypeError(f"expected integer codes, got {t.dtype}")
    n, d = codes.shape
    x = codes.to(torch.int32).contiguous()
    c = centers.to(torch.int32).contiguous()
    valid = center_valid.to(torch.int32).contiguous()
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return labels, counts
    err = _entry("repro_hamming_argmin_i32", _EQ_ARGTYPES)(
        x.data_ptr(), c.data_ptr(), valid.data_ptr(), n, c.shape[0], d,
        labels.data_ptr(), counts.data_ptr(), *_stream(dev))
    build.check(err, "distance_argmin_hamming")
    distance_argmin_hamming.launches += 1
    return labels, counts


distance_argmin_hamming.launches = 0


def distance_argmin_hamming_packed(packed: torch.Tensor,
                                   packed_centers: torch.Tensor,
                                   center_valid: torch.Tensor, *, bits: int,
                                   d: int | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the packed kernel: (labels (n,) int32, counts (n,) int32).

    ``packed`` (n, w) and ``packed_centers`` (k, w) are int32 tensors
    holding uint32 words' bits (``pack.pack_codes``), read by the kernel
    as they are. ``d`` is the unpacked width: an invalid center counts ``d + 1``
    (int32 max without it). Counts one launch in
    ``distance_argmin_hamming_packed.launches``.
    """
    what = "distance_argmin_hamming_packed"
    dev = _check(packed, packed_centers, center_valid, what)
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    for t in (packed, packed_centers):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32 words (pack_codes), "
                            f"got {t.dtype}")
    n, w = packed.shape
    big = INT32_MAX if d is None else int(d) + 1
    x = packed.contiguous()
    c = packed_centers.contiguous()
    valid = center_valid.to(torch.int32).contiguous()
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return labels, counts
    err = _entry("repro_hamming_packed_argmin_u32", _PK_ARGTYPES)(
        x.data_ptr(), c.data_ptr(), valid.data_ptr(), n, c.shape[0], w, bits,
        big, labels.data_ptr(), counts.data_ptr(), *_stream(dev))
    build.check(err, what)
    distance_argmin_hamming_packed.launches += 1
    return labels, counts


distance_argmin_hamming_packed.launches = 0
