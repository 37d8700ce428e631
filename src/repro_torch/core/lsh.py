"""LSH families used by GEEK's data transformation (paper §2.2, §3.1).

The counterpart of ``repro.core.lsh``:

- QALSH projections : h_a(x) = a·x, a ~ N(0, I)   (Euclidean)
- MinHash           : h_pi(A) = min_{a in A} pi(a) (Jaccard), over item
                      sets and, in SILK, over bucket segments
- DOPH              : densified one-permutation hashing (sparse sets)

The reference derives each hash pair from a JAX key inside these
functions; here the caller passes the derived (a, b) pairs (uint32 in
the int64 carrier), drawn by ``api.LSHBucketer.split_key``.
"""
from __future__ import annotations

import torch

from repro_torch.utils.hashing import (M32, UMAX32, combine2_u32, hash_u32,
                                       mix_u32)


def qalsh_projections(gen: torch.Generator, d: int, m: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Draw m i.i.d. QALSH functions: a (d, m) matrix with N(0,1) entries,
    on the generator's device."""
    return torch.randn((d, m), generator=gen, device=gen.device, dtype=dtype)


def qalsh_hash(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """h_a(x) = a·x for a batch: (n, d) @ (d, m) -> (n, m)."""
    return x @ a


def minhash_signatures(
    items: torch.Tensor,           # (n, s) item ids (int32 or carried uint32)
    mask: torch.Tensor | None,     # (n, s) bool — True for real items
    keys: torch.Tensor,            # (L, K, 2) uint32 hash keys (carrier)
) -> torch.Tensor:
    """(L, n) signatures: per table, K minhashes of each row's items mixed
    together. ``mask=None`` means every item is real.

    One table at a time: the (n, s) int64 hash of one key is the largest
    temporary, never (L, n, s).
    """
    L, K, _ = keys.shape
    out = torch.empty((L, items.shape[0]), dtype=torch.int64,
                      device=items.device)
    for t in range(L):
        sig = torch.zeros((items.shape[0],), dtype=torch.int64,
                          device=items.device)
        for k in range(K):
            hv = hash_u32(items, keys[t, k, 0], keys[t, k, 1])
            if mask is not None:
                hv = torch.where(mask, hv, UMAX32)
            sig = mix_u32(sig, torch.min(hv, dim=-1).values)
        out[t] = sig
    return out


def code_items(codes: torch.Tensor, item_keys: torch.Tensor) -> torch.Tensor:
    """Attribute-value pairs as hashed set items: item_j = H(j, code_j).

    ``item_keys`` is the (1, 2) (or (2,)) item-hash pair. Turns (n, d)
    codes into (n, d) carried uint32 items, so Jaccard over the items
    approximates normalized Hamming over the codes.
    """
    hk = item_keys.reshape(2)
    dims = torch.arange(codes.shape[1], dtype=torch.int64,
                        device=codes.device)[None, :]
    return combine2_u32(dims.expand(codes.shape), codes, hk[0], hk[1])


def doph_codes(
    sets: torch.Tensor,            # (n, s) item ids (padded)
    mask: torch.Tensor,            # (n, s) bool
    doph_hash: torch.Tensor,       # (1, 2) or (2,) uint32 hash pair (carrier)
    m: int,                        # output dimensionality
) -> torch.Tensor:
    """(n, m) carried uint32 minwise codes; Pr[code_i(A) == code_i(B)] ≈ J.

    One permutation hash splits the hash range into m bins and takes the
    min per bin; an empty bin borrows from the nearest non-empty bin to
    its right (cyclically), offset by the borrow distance times
    0x9E3779B1. The reference's per-set ``segment_min`` is one
    ``scatter_reduce("amin")`` over row-offset bins, and its
    ``associative_scan`` suffix-min is ``flip(cummin(flip(.)))``.
    """
    n = sets.shape[0]
    hk = doph_hash.reshape(2)
    h = torch.where(mask, hash_u32(sets, hk[0], hk[1]), UMAX32)
    bins = torch.where(mask, h % m, m)          # padded items -> overflow bin
    flat = (torch.arange(n, dtype=torch.int64, device=sets.device)[:, None]
            * (m + 1) + bins).reshape(-1)
    vals = torch.full((n * (m + 1),), UMAX32, dtype=torch.int64,
                      device=sets.device)
    vals = vals.scatter_reduce(0, flat, h.reshape(-1), "amin",
                               include_self=True).view(n, m + 1)[:, :m]
    del h, bins, flat
    empty = vals == UMAX32
    idx = torch.arange(2 * m, dtype=torch.int64, device=sets.device)
    cand = torch.where((~empty).repeat(1, 2), idx, 2 * m)
    j = torch.flip(torch.cummin(torch.flip(cand, (1,)), dim=1).values,
                   (1,))[:, :m]
    dist = j - idx[:m]                           # in [0, 2m]: no wrap
    borrowed = (torch.gather(vals, 1, j % m) + dist * 0x9E3779B1) & M32
    return torch.where(empty, borrowed, vals)


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
