"""LSH families used by GEEK's data transformation (paper §2.2, §3.1).

The dense part of ``repro.core.lsh``:

- QALSH projections : h_a(x) = a·x, a ~ N(0, I)   (Euclidean)
- MinHash over bucket segments, the plain version of SILK's bucket hash
"""
from __future__ import annotations

import torch

from repro_torch.utils.hashing import UMAX32, hash_u32, mix_u32


def qalsh_projections(gen: torch.Generator, d: int, m: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Draw m i.i.d. QALSH functions: a (d, m) matrix with N(0,1) entries,
    on the generator's device."""
    return torch.randn((d, m), generator=gen, device=gen.device, dtype=dtype)


def qalsh_hash(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """h_a(x) = a·x for a batch: (n, d) @ (d, m) -> (n, m)."""
    return x @ a


def minhash_over_segments(
    values: torch.Tensor,          # (P,) int32 member ids (flattened buckets)
    segments: torch.Tensor,        # (P,) int bucket index per member
    num_segments: int,
    keys: torch.Tensor,            # (K, 2) uint32 carried in int64
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(num_segments,) signature per bucket = K segment-min hashes mixed.

    MinHash applied to buckets as sets of data ids, the core of SILK
    (paper §3.2). Returned in the int64 uint32 carrier. An empty segment
    mixes ``UMAX32``, the identity of a uint32 segment-min. This is the
    plain version; ``kernels.minhash_buckets`` runs the same function on
    the card over contiguous segments.
    """
    seg = segments.to(torch.int64)
    sig = torch.zeros((num_segments,), dtype=torch.int64, device=values.device)
    for k in range(keys.shape[0]):
        hv = hash_u32(values, keys[k, 0], keys[k, 1])
        if valid is not None:
            hv = torch.where(valid, hv, UMAX32)
        mins = torch.full((num_segments,), UMAX32, dtype=torch.int64,
                          device=values.device)
        mins = mins.scatter_reduce(0, seg, hv, "amin", include_self=True)
        sig = mix_u32(sig, mins)
    return sig
