"""Unified bucket format (paper §3.1), the counterpart of
``repro.core.buckets``.

A ``BucketTables`` is T hash tables over the same n objects. In table t,
object ``ids[t, p]`` lives in bucket ``segments[t, p]`` (dense per-table
index, ascending along p). The flattened view is table-major, so its
global segment ids ascend and every bucket is one contiguous run: the
property that lets SILK hash the buckets over CSR offsets.

Two construction paths: ``partition_even`` (QALSH rank partition, dense
data, Algorithm 1) and ``partition_by_signature`` (MinHash (K, L)
bucketing, hetero and sparse data, Algorithms 2 and 3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BucketTables(NamedTuple):
    """T LSH hash tables over the same n objects (see module docstring)."""

    ids: torch.Tensor          # (T, n) int32 — data ids, sorted by bucket
    segments: torch.Tensor     # (T, n) int32 — dense bucket index in table
    num_buckets: torch.Tensor  # (T,)  int32 — # non-empty buckets per table
    buckets_per_table: int     # static cap on buckets per table

    @property
    def num_tables(self) -> int:
        """Number of hash tables T."""
        return self.ids.shape[0]

    @property
    def n(self) -> int:
        """Number of objects per table."""
        return self.ids.shape[1]

    @property
    def total_bucket_cap(self) -> int:
        """Static cap on global bucket ids: T · buckets_per_table."""
        return self.num_tables * self.buckets_per_table

    def flatten(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(T·n,) ids and *global* segment ids (table offset applied)."""
        T = self.num_tables
        offs = (torch.arange(T, dtype=torch.int32, device=self.ids.device)
                * self.buckets_per_table)[:, None]
        return self.ids.reshape(-1), (self.segments + offs).reshape(-1)


def partition_even(h: torch.Tensor, t: int) -> BucketTables:
    """Algorithm 1: sort each hash table, evenly partition into t buckets.

    h: (n, m) QALSH values. Bucket of the rank-r object is floor(r·t/n).
    The sort is stable, as ``jnp.argsort`` is: ties keep id order.
    """
    n, m = h.shape
    order = torch.argsort(h, dim=0, stable=True)              # (n, m)
    ranks = torch.arange(n, dtype=torch.int64, device=h.device)
    seg = (ranks * t // n).to(torch.int32)                   # (n,)
    ids = order.T.to(torch.int32).contiguous()               # (m, n)
    segments = seg.expand(m, n)
    return BucketTables(ids, segments,
                        torch.full((m,), t, dtype=torch.int32, device=h.device),
                        t)


def partition_by_signature(sigs: torch.Tensor) -> BucketTables:
    """Algorithms 2 & 3: group objects whose MinHash signatures collide.

    sigs: (L, n) carried uint32. Buckets per table are capped at n, so
    the flattened tables span L·n global bucket ids, mostly empty. The
    sort is stable, as ``jnp.argsort`` is: equal signatures keep id order.
    """
    n = sigs.shape[1]
    ss, order = torch.sort(sigs, dim=1, stable=True)
    starts = torch.ones_like(ss, dtype=torch.int32)
    starts[:, 1:] = (ss[:, 1:] != ss[:, :-1]).to(torch.int32)
    seg = torch.cumsum(starts, dim=1, dtype=torch.int32) - 1
    return BucketTables(order.to(torch.int32), seg, seg[:, -1] + 1, n)


# ---------------------------------------------------------------------------
# Owned-table slices: the bucket-id-range partition of the sharded fit
# ---------------------------------------------------------------------------
# Global bucket ids are table-major (``flatten``), so a contiguous block of
# tables per rank is a contiguous range of bucket ids. These run the exact
# per-table math of ``partition_even`` / ``partition_by_signature`` on an
# owned slice and also return ``b_of_id``, the bucket of each object, that
# the distributed majority vote sends back to the id owners
# (``core.distributed.discover_sharded``).

def rank_partition_slice(h_cols: torch.Tensor, t: int):
    """Algorithm 1 on an owned column slice of the QALSH hash matrix.

    ``h_cols`` (n, mt): the mt owned tables' hash values for ALL n
    objects. The per-column math is ``partition_even``'s (stable argsort,
    even rank cut), so table τ is bit-identical to the in-core fit's.
    Returns ``(ids, segments, b_of_id, sizes)``: ``ids`` / ``segments``
    (mt, n) as in ``BucketTables``, ``b_of_id`` (mt, n) the bucket of
    each object, ``sizes`` (mt, t) the entries per bucket.
    """
    n, mt = h_cols.shape
    dev = h_cols.device
    order = torch.argsort(h_cols, dim=0, stable=True)
    seg = (torch.arange(n, dtype=torch.int64, device=dev) * t // n
           ).to(torch.int32)
    ids = order.T.to(torch.int32).contiguous()
    segments = seg.expand(mt, n)
    b_of_id = torch.zeros((mt, n), dtype=torch.int32, device=dev).scatter_(
        1, ids.to(torch.int64), segments)
    sizes = torch.bincount(seg.to(torch.int64), minlength=t).to(torch.int32)
    return ids, segments, b_of_id, sizes.expand(mt, t)


def signature_partition_slice(sigs: torch.Tensor):
    """Algorithms 2 & 3 on an owned row slice of the signature matrix.

    ``sigs`` (mt, n): the mt owned tables' MinHash signatures for ALL n
    objects (carried uint32). The per-table math is
    ``partition_by_signature``'s (stable sort, run numbering), so table τ
    is bit-identical to the in-core fit's. Returns ``(ids, segments,
    b_of_id, sizes)`` as ``rank_partition_slice``, with a bucket cap of n
    per table.
    """
    mt, n = sigs.shape
    tables = partition_by_signature(sigs)
    ids, seg = tables.ids, tables.segments
    b_of_id = torch.zeros((mt, n), dtype=torch.int32,
                          device=sigs.device).scatter_(1, ids.to(torch.int64),
                                                       seg)
    sizes = torch.zeros((mt, n), dtype=torch.int32,
                        device=sigs.device).scatter_add_(
        1, seg.to(torch.int64), torch.ones_like(seg))
    return ids, seg, b_of_id, sizes
