"""SILK — Seeding based on simILar bucKets (paper §3.2, Algorithm 4).

The counterpart of ``repro.core.silk``. Per SILK hash table:
  1. MinHash each bucket (a set of data ids) into a K-fold signature.
  2. Buckets with colliding signatures form a bin.
  3. Majority voting inside each bin: ids present in more than half of the
     bin's buckets form the shared core.
  4. Cores with at least ``delta`` ids become candidate seed groups.
One more round over the cores themselves removes near-duplicates.

Every step is a sort or a segment operation with the reference's exact
integer semantics, so ``Seeds``, ``k_star`` and ``overflow`` are
bit-identical to ``repro`` for the same bucket tables and keys. The L
seeding rounds hash their buckets through ``kernels.ops.minhash_segments``
(the hand-written kernel on the card); ``rowwise_majority`` is the same
vote re-expressed per object, for the sharded fit (``core.distributed``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.buckets import BucketTables
from repro_torch.core.lsh import minhash_over_segments
from repro_torch.kernels import ops as kops
from repro_torch.utils.hashing import run_starts


class SeedPairs(NamedTuple):
    """Padded (group, id) membership pairs for candidate seed groups."""
    group: torch.Tensor       # (C,) int32 — dense group index, -1 when invalid
    id: torch.Tensor          # (C,) int32 — data id
    valid: torch.Tensor       # (C,) bool
    num_groups: torch.Tensor  # ()  int32
    overflow: torch.Tensor    # ()  int32 — pairs dropped by the static cap


class Seeds(NamedTuple):
    """Final seed groups after dedup + top-k_max selection."""
    group: torch.Tensor       # (C,) int32 in [0, k_max) or -1
    id: torch.Tensor          # (C,) int32
    valid: torch.Tensor       # (C,) bool
    k_star: torch.Tensor      # ()  int32 — discovered number of seeds (k*)
    k_max: int                # static budget


def lexsort(keys: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """``jnp.lexsort``: the LAST key is the primary one.

    Chained stable sorts, least significant key first; bool keys sort
    as integers (False before True).
    """
    order = None
    for k in keys:
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        if order is None:
            order = torch.argsort(k, stable=True)
        else:
            order = order[torch.argsort(k[order], stable=True)]
    return order


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ids outside [0, num) are dropped.

    ``cumsum(...) - 1`` yields -1 wherever a sorted prefix holds no valid
    entry; those land in a spare slot that is cut off. Integer sums only
    (order-independent, so the result is deterministic on the card).
    """
    ids = ids.to(torch.int64)
    inr = (ids >= 0) & (ids < num)
    out = torch.zeros((num + 1,), dtype=vals.dtype, device=vals.device)
    out.scatter_add_(0, torch.where(inr, ids, num), vals)
    return out[:num]


def _cumsum_ids(starts: torch.Tensor) -> torch.Tensor:
    """Dense run ids from start markers: ``cumsum(starts) - 1`` (int32)."""
    return torch.cumsum(starts, 0, dtype=torch.int32) - 1


def compact_pairs(group, ids, valid, cap: int):
    """Keep at most ``cap`` pairs, lowest group ids first (deterministic).

    Valid pairs sort ahead of invalid ones by (group, id). Returns
    ``(group, ids, valid, overflow)`` with ``overflow`` counting valid
    pairs dropped by the cap.
    """
    order = lexsort((ids, group, ~valid))
    overflow = torch.clamp(valid.sum() - cap, min=0).to(torch.int32)
    take = order[:cap]
    return group[take], ids[take], valid[take], overflow


def bins_from_signatures(sig: torch.Tensor, bucket_valid: torch.Tensor):
    """Group buckets with colliding signatures into bins (paper §3.2).

    Bins are numbered in ascending-signature order; invalid buckets sort
    last and never start or join a bin. Returns ``(bin_of_bucket,
    bin_nbuckets)``; ``bin_of_bucket`` is garbage for invalid buckets.
    """
    nbcap = sig.shape[0]
    border = lexsort((sig, ~bucket_valid))               # valid first, by sig
    sig_s = sig[border]
    bval_s = bucket_valid[border]
    bin_id_s = _cumsum_ids(run_starts(sig_s, valid=bval_s))
    bin_of_bucket = torch.zeros((nbcap,), dtype=torch.int32,
                                device=sig.device).scatter_(0, border, bin_id_s)
    bin_nbuckets = segment_sum(bval_s.to(torch.int32), bin_id_s, nbcap)
    return bin_of_bucket, bin_nbuckets


def rowwise_majority(bins_rows: torch.Tensor, bin_nbuckets: torch.Tensor,
                     min_bin_size: int):
    """Majority voting, re-expressed per object (one row per object).

    ``bins_rows[i, t]`` is the bin that object i's bucket in table t
    landed in (sentinel ``nbcap`` for a padding slot). Each object appears
    once per table, so the multiset of a row's bins is the multiset of
    that object's (bin, id) entries that ``silk_round`` votes over:
    sorting the row and counting its runs gives the same verdicts,
    partitioned by object. Returns ``(srt, maj)``: the row-sorted bins
    and a mask, True at the first entry of each majority run.
    """
    nbcap = bin_nbuckets.shape[0]
    srt = torch.sort(bins_rows, dim=1).values.contiguous()
    cnt = (torch.searchsorted(srt, srt, side="right")
           - torch.searchsorted(srt, srt, side="left")).to(torch.int32)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    nb = bin_nbuckets[srt.clamp(0, nbcap - 1).to(torch.int64)]
    maj = first & (srt < nbcap) & (cnt * 2 > nb) & (nb >= min_bin_size)
    return srt, maj


def silk_round(
    flat_ids: torch.Tensor,      # (P,) int32 — bucket member ids
    flat_seg: torch.Tensor,      # (P,) int32 — global bucket index in [0, nbcap)
    entry_valid: torch.Tensor,   # (P,) bool
    nbcap: int,                  # static cap on #buckets
    keys: torch.Tensor,          # (K, 2) uint32 (int64 carrier) for this table
    delta: int,                  # seeding threshold (paper: delta)
    min_bin_size: int,           # 2 for seeding (skip |Bin|<=1), 1 for dedup
    pair_cap: int,
    *,
    offsets: torch.Tensor | None = None,
) -> SeedPairs:
    """One SILK table: bucket-minhash -> bins -> majority vote -> cores.

    ``offsets`` (nbcap + 1,) are the CSR bounds of ``flat_seg`` when it is
    sorted and every entry is valid, as on the L seeding rounds: the
    bucket MinHash then runs through ``kops.minhash_segments`` (the
    kernel on the card). The dedup round's segments are unsorted and
    masked; it has no kernel and hashes through the plain version on
    every device, as the reference's main path does.
    """
    P = flat_ids.shape[0]
    sizes = segment_sum(entry_valid.to(torch.int32), flat_seg, nbcap)
    if offsets is None:
        sig = minhash_over_segments(flat_ids, flat_seg, nbcap, keys,
                                    valid=entry_valid)
    else:
        sig = kops.minhash_segments(flat_ids, offsets, keys)
    bin_of_bucket, bin_nbuckets = bins_from_signatures(sig, sizes > 0)

    # -- majority voting over (bin, id) pairs --------------------------------
    ebin = bin_of_bucket[flat_seg.to(torch.int64)]
    eorder = lexsort((flat_ids, ebin, ~entry_valid))
    eb_s = ebin[eorder]
    id_s = flat_ids[eorder]
    ev_s = entry_valid[eorder]
    rstarts = run_starts(eb_s, id_s, valid=ev_s)
    run_id = _cumsum_ids(rstarts)
    counts = segment_sum(ev_s.to(torch.int32), run_id, P)
    # -1 ids (no run yet, or no valid bucket at all) only sit on entries
    # that never start a run, so what they read does not matter
    eb_i = eb_s.to(torch.int64).clamp(min=0)
    cnt_here = counts[run_id.to(torch.int64).clamp(min=0)]
    nb_here = bin_nbuckets[eb_i]
    maj = rstarts & (cnt_here * 2 > nb_here) & (nb_here >= min_bin_size)

    # -- seed-group selection: |C_shared| >= delta ---------------------------
    core_size = segment_sum(maj.to(torch.int32), eb_s, nbcap)
    keep_bin = core_size >= delta
    new_group_of_bin = _cumsum_ids(keep_bin)
    num_groups = keep_bin.sum().to(torch.int32)

    out_valid = maj & keep_bin[eb_i]
    out_group = torch.where(out_valid, new_group_of_bin[eb_i], -1)
    g, i, v, overflow = compact_pairs(out_group, id_s, out_valid, pair_cap)
    return SeedPairs(g, i, v, num_groups, overflow)


def select_top_groups(pairs: SeedPairs, group_cap: int, k_max: int) -> Seeds:
    """Keep the k_max largest groups (ties: lower group id first, as
    ``jax.lax.top_k``; hence a stable descending sort, not ``topk``)."""
    if k_max > group_cap:
        raise ValueError(f"k_max={k_max} exceeds the group cap {group_cap}")
    dev = pairs.group.device
    gidx = torch.where(pairs.valid, pairs.group, group_cap)
    sizes = segment_sum(pairs.valid.to(torch.int32), gidx,
                        group_cap + 1)[:group_cap]
    top_sizes, top_idx = torch.sort(sizes, descending=True, stable=True)
    top_sizes, top_idx = top_sizes[:k_max], top_idx[:k_max]
    remap = torch.full((group_cap + 1,), -1, dtype=torch.int32, device=dev)
    remap[top_idx] = torch.where(
        top_sizes > 0, torch.arange(k_max, dtype=torch.int32, device=dev), -1)
    new_group = remap[gidx.to(torch.int64)]
    valid = pairs.valid & (new_group >= 0)
    k_star = (top_sizes > 0).sum().to(torch.int32)
    return Seeds(torch.where(valid, new_group, -1), pairs.id, valid, k_star,
                 k_max)


def silk_seeding(
    buckets: BucketTables,
    table_keys: torch.Tensor,
    *,
    silk_k: int,
    silk_l: int,
    delta: int,
    pair_cap: int,
    k_max: int,
) -> tuple[Seeds, torch.Tensor]:
    """Full SILK (Algorithm 4): L seeding rounds + one dedup round.

    ``table_keys`` is the (silk_l + 1, silk_k, 2) uint32 key table (int64
    carrier) that ``repro`` derives inside its ``silk_seeding``; the
    facade draws it (``api.LSHBucketer.split_key``). Returns (seeds,
    total_overflow); overflow > 0 means ``pair_cap`` truncated cores.
    """
    if tuple(table_keys.shape) != (silk_l + 1, silk_k, 2):
        raise ValueError(f"table_keys must be ({silk_l + 1}, {silk_k}, 2), "
                         f"got {tuple(table_keys.shape)}")
    flat_ids, flat_seg = buckets.flatten()
    entry_valid = torch.ones_like(flat_ids, dtype=torch.bool)
    nbcap = buckets.total_bucket_cap
    offsets = csr_offsets(flat_seg, nbcap)
    rounds = [silk_round(flat_ids, flat_seg, entry_valid, nbcap,
                         table_keys[r], delta, 2, pair_cap, offsets=offsets)
              for r in range(silk_l)]
    return dedup_and_select(rounds, table_keys[silk_l], pair_cap=pair_cap,
                            k_max=k_max)


def csr_offsets(flat_seg: torch.Tensor, nbcap: int) -> torch.Tensor:
    """(nbcap + 1,) int32 CSR bounds of ascending global bucket ids: the
    flattened tables are table-major with ascending buckets, so each
    bucket is one contiguous run of entries, with no padding."""
    return torch.searchsorted(
        flat_seg, torch.arange(nbcap + 1, dtype=flat_seg.dtype,
                               device=flat_seg.device)).to(torch.int32)


def dedup_and_select(rounds: list, dedup_keys: torch.Tensor, *,
                     pair_cap: int, k_max: int) -> tuple[Seeds, torch.Tensor]:
    """The dedup round over the L seeding rounds' cores, then the k_max
    largest groups. Returns (seeds, total overflow)."""
    # stack rounds; group ids offset per round (each round's groups < pair_cap)
    cat_group = torch.cat([torch.where(rd.valid, rd.group + r * pair_cap, -1)
                           for r, rd in enumerate(rounds)])
    cat_ids = torch.cat([rd.id for rd in rounds])
    cat_valid = torch.cat([rd.valid for rd in rounds])
    group_cap = len(rounds) * pair_cap

    # dedup round: cores are buckets now; singleton bins are kept
    seg = torch.where(cat_valid, cat_group, group_cap - 1)
    dedup = silk_round(cat_ids, seg, cat_valid, group_cap, dedup_keys, 1, 1,
                       pair_cap)

    seeds = select_top_groups(dedup, pair_cap, k_max)
    overflow = torch.stack([rd.overflow for rd in rounds]).sum() + dedup.overflow
    return seeds, overflow.to(torch.int32)
