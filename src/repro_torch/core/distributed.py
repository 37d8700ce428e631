"""Multi-device GEEK on ``torch.distributed``: the sharded fit's machinery,
sharded serving, and the paper's table-sync fit (paper §3.4).

The counterpart of ``repro.core.distributed``. Where the reference runs a
``shard_map`` body on every device of a ``jax.sharding.Mesh``, the port
runs the same body on every rank of a process group
(``utils.compat.Mesh``): NCCL between cards, gloo between CPU processes.
Every rank is handed the same global data, as ``repro``'s callers hand
it, and takes its own rows: the rows are cyclically padded to a multiple
of the world size g and cut into g contiguous blocks of nl = n_pad / g
(``_pad_and_shard``); rank r holds global rows r·nl .. (r + 1)·nl − 1.

Two paths live here, as in the reference:

1. **The sharded fit's machinery** (the bodies are in ``core.api``, behind
   ``GEEK.fit(..., mesh=)``): distributed SILK discovery
   (``discover_sharded``: each rank owns a contiguous block of hash
   tables, which is a contiguous range of global bucket ids; hash
   columns or signature rows cross once by a tiled all-to-all, the
   bucket map crosses back once, and each SILK round moves only
   bucket-level vectors and the top ``pair_cap`` candidate pairs), the
   row gathers and ``make_predict_sharded``. Bit-identical to the
   in-core fit: every stage replays the in-core integer math on the
   in-core inputs, or splits work whose result does not depend on the
   split.

2. **The table-sync dense fit** (``make_fit_dense``), the paper's MPI
   design on collectives: local QALSH, boundaries from an all-gathered
   stride sample, one all-to-all that hands each rank whole tables, SILK
   on local tables, the small C_shared pairs all-gathered and
   de-duplicated, centroids by an all-reduce, optional Lloyd refine
   sweeps (each one pass of ``kernels.ops.distance_argmin_l2`` with
   ``accumulate=True``, the hand-written kernel on the card, and one
   all-reduce of the (k, d) partials, int8 on the wire under
   ``GeekConfig.compress_collectives``), and a local one-pass assignment.
   Discovery here is approximate against the in-core fit, as in the
   reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import assign as assign_mod
from repro_torch.core import lsh
from repro_torch.core.buckets import (BucketTables, rank_partition_slice,
                                      signature_partition_slice)
from repro_torch.core.geek import (GeekConfig, make_hetero_transform,
                                   make_sparse_transform)
from repro_torch.core.model import (GeekModel, NumericDiscretizer, predict,
                                    quantile_boundaries)
from repro_torch.core.silk import (SeedPairs, Seeds, bins_from_signatures,
                                   compact_pairs, csr_offsets,
                                   dedup_and_select, rowwise_majority,
                                   segment_sum, select_top_groups, silk_round)
from repro_torch.core.transform import HeteroTransform, IdentityTransform
from repro_torch.distributed.compression import (compressed_psum,
                                                 narrow_int_all_to_all)
from repro_torch.kernels import ops as kops
from repro_torch.utils import compat
from repro_torch.utils.compat import (Mesh, all_gather, all_to_all, axis_index,
                                     axis_size, pmax, psum)
from repro_torch.utils.device import (full_precision_matmul, parts_to_device,
                                      resolve_device)
from repro_torch.utils.hashing import derive_hash_keys


def _pad_and_shard(present: list, mesh: Mesh) -> tuple[list, int]:
    """This rank's rows of the global parts, cyclically padded.

    Every part must have the same n rows. Rows are padded to a multiple
    of g by repeating rows from the start (duplicates, never sentinels),
    and rank r takes the r-th contiguous block. Returns ``(local_parts,
    n)`` with n the true row count.
    """
    rows = {int(p.shape[0]) for p in present}
    if len(rows) != 1:
        raise ValueError(f"input parts disagree on rows: {rows}")
    n = rows.pop()
    g, r = axis_size(mesh), axis_index(mesh)
    nl = -(-n // g)
    if nl * g == n:
        return [p[r * nl:(r + 1) * nl] for p in present], n
    idx = torch.arange(r * nl, (r + 1) * nl, device=present[0].device) % n
    return [p[idx] for p in present], n


def _reinsert_none(local: list, pattern: tuple) -> tuple:
    """Put ``None`` back where ``pattern`` (True = absent) says."""
    it = iter(local)
    return tuple(None if absent else next(it) for absent in pattern)


def _gather_rows(a_local: torch.Tensor, mesh: Mesh, keep: int | None
                 ) -> torch.Tensor:
    """All-gather per-rank row blocks into one (g·s, ...) tensor in rank
    order, which is global row order for contiguous shards; ``keep``
    cuts trailing padding rows (``None`` keeps all)."""
    out = all_gather(a_local, mesh).reshape((-1,) + tuple(a_local.shape[1:]))
    return out if keep is None else out[:keep]


# ---------------------------------------------------------------------------
# Distributed SILK discovery (the default sharded fit)
# ---------------------------------------------------------------------------
# Layouts (g ranks, n true rows, nl = n_pad / g):
#   row layout   — (nl, ·) per rank, global row id = rank·nl + i
#   table layout — each rank owns a contiguous block of hash tables;
#                  global bucket ids are table-major, so table ownership is
#                  a bucket-id-range partition
#   wire         — hash values / signatures cross once (row -> table
#                  layout), the bucket map crosses back once (narrow ints
#                  under cfg.compress_collectives); per SILK round only
#                  bucket-level vectors and the top pair_cap pairs move.

def exchange_columns(x_local: torch.Tensor, mesh: Mesh, n: int
                     ) -> torch.Tensor:
    """Row layout -> column-owner layout: (nl, W) -> (n, W_pad / g).

    Trailing columns are padded with zeros to a multiple of g (callers
    mask pad tables out), and the rows are cut back to the true n, so
    each rank holds full columns of its owned slice in global row order.
    """
    g = axis_size(mesh)
    w = x_local.shape[1]
    wp = -(-w // g) * g
    if wp != w:
        x_local = torch.nn.functional.pad(x_local, (0, wp - w))
    return all_to_all(x_local, mesh, split_axis=1, concat_axis=0)[:n]


def exchange_rows(x_local: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """Row layout -> row-owner layout: (R, nl) -> (R_pad / g, n), the
    transpose twin of ``exchange_columns`` for (tables, rows) payloads
    (MinHash signature matrices)."""
    g = axis_size(mesh)
    r = x_local.shape[0]
    rp = -(-r // g) * g
    if rp != r:
        x_local = torch.nn.functional.pad(x_local, (0, 0, 0, rp - r))
    return all_to_all(x_local, mesh, split_axis=0, concat_axis=1)[:, :n]


def scatter_table_rows(b_of_id: torch.Tensor, mesh: Mesh, sentinel: int,
                       compress: bool) -> torch.Tensor:
    """Table layout -> row layout: (mt, n) bucket map -> (T_pad, nl).

    Each rank ends up with, for its own rows, the bucket they landed in
    under every table; pad rows get ``sentinel``. With ``compress`` the
    payload ships as the narrowest lossless unsigned integer (bucket ids
    are below ``sentinel``), exactly.
    """
    g = axis_size(mesh)
    n = b_of_id.shape[1]
    n_pad = -(-n // g) * g
    if n_pad != n:
        b_of_id = torch.nn.functional.pad(b_of_id, (0, n_pad - n),
                                          value=sentinel)
    if compress:
        return narrow_int_all_to_all(b_of_id, mesh, sentinel + 1,
                                     split_axis=1, concat_axis=0)
    return all_to_all(b_of_id, mesh, split_axis=1, concat_axis=0)


def collect_seed_rows(space_local: torch.Tensor, ids: torch.Tensor,
                      valid: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows named by global ``ids``, on every rank.

    Each id has one owner (contiguous row blocks partition the padded
    rows), so each rank contributes its own rows and zeros elsewhere, and
    an all-reduce sum rebuilds them: exact for integer codes and, for
    floats, bitwise but for the (-0.0 + 0.0) corner. Invalid lanes come
    back as zero rows (the center math weights them zero anyway).
    """
    nl = space_local.shape[0]
    lo = axis_index(mesh) * nl
    ids = ids.to(torch.int64)
    own = valid & (ids >= lo) & (ids < lo + nl)
    rel = (ids - lo).clamp(0, nl - 1)
    rows = torch.where(own[:, None], space_local[rel],
                       torch.zeros((), dtype=space_local.dtype,
                                   device=space_local.device))
    return psum(rows, mesh)


def fit_transform_sharded(kind: str, parts: tuple, tkeys, cfg: GeekConfig,
                          mesh: Mesh, n: int):
    """Fit the persistent transform from sharded rows, exactly.

    Dense (identity) and sparse (keyed DOPH) transforms do not depend on
    the data. The hetero quantile boundaries need global per-column
    sorts: columns go to their owners (``exchange_columns``), each owner
    replays the in-core sort + ``quantile_boundaries`` on its full
    columns, and the small (d_num, t_cat − 1) boundaries are all-gathered:
    ``NumericDiscretizer.fit``'s boundaries, bit for bit.
    """
    if kind == "dense":
        return IdentityTransform()
    if kind == "sparse":
        return make_sparse_transform(tkeys, cfg)
    x_num = parts[0]
    if x_num is None or x_num.shape[1] == 0:
        return make_hetero_transform(x_num, cfg.t_cat)
    d_num = x_num.shape[1]
    cols = exchange_columns(x_num, mesh, n)
    b_local = quantile_boundaries(torch.sort(cols, dim=0).values, cfg.t_cat)
    boundaries = all_gather(b_local, mesh).reshape(-1, b_local.shape[1])
    return HeteroTransform(NumericDiscretizer(boundaries[:d_num].contiguous()))


def silk_seeding_sharded(ids_t: torch.Tensor, seg_t: torch.Tensor,
                         sizes: torch.Tensor, bins_rows: torch.Tensor,
                         table_keys: torch.Tensor, cfg: GeekConfig,
                         mesh: Mesh, *, n: int, num_tables: int, cap_t: int
                         ) -> tuple[Seeds, torch.Tensor]:
    """Distributed SILK: rank-local voting, hierarchical group merge.

    Per round (L rounds, then the dedup, with ``silk_seeding``'s keys):

    1. each table owner MinHashes its owned buckets (the bucket MinHash
       kernel on the card, over CSR offsets); the per-bucket signatures
       and sizes are all-gathered and cut to the in-core layout;
    2. bins form on every rank (``silk.bins_from_signatures``);
    3. majority voting runs on each rank's own rows
       (``silk.rowwise_majority`` over the exchanged bucket map), and the
       per-bin core sizes are summed over ranks, exactly;
    4. each rank compacts its top ``pair_cap`` candidate pairs, the
       candidates are all-gathered and compacted once more: the global
       top ``pair_cap`` is inside the union of the local ones; overflow
       comes from the summed true candidate count.

    The dedup round and the top-group selection then run on every rank on
    the merged pairs, as in-core.

    ``ids_t`` / ``seg_t`` (mt, n) are the owned tables' entries,
    ``sizes`` (mt, cap_t) their bucket sizes, ``bins_rows`` (T_pad, nl)
    the exchanged bucket map (pad slots ``cap_t``) and ``table_keys`` the
    (silk_l + 1, silk_k, 2) SILK keys. Returns ``(seeds, overflow)`` with
    global row ids, the same on every rank and bit-identical to
    ``silk_seeding`` on the in-core tables.
    """
    dev = ids_t.device
    mt = ids_t.shape[0]
    nl = bins_rows.shape[1]
    nbcap = num_tables * cap_t
    flat_ids = ids_t.reshape(-1)
    flat_seg = (seg_t + (torch.arange(mt, dtype=torch.int32, device=dev)
                         * cap_t)[:, None]).reshape(-1)
    offsets = csr_offsets(flat_seg, mt * cap_t)

    sizes_all = all_gather(sizes.contiguous(), mesh).reshape(-1, cap_t)
    bucket_valid = (sizes_all[:num_tables] > 0).reshape(-1)

    gid = axis_index(mesh) * nl + torch.arange(nl, dtype=torch.int64,
                                               device=dev)
    tb = bins_rows.T.to(torch.int64)                          # (nl, T_pad)
    goff = (torch.arange(tb.shape[1], dtype=torch.int64, device=dev)
            * cap_t)[None, :]
    entry_real = (tb < cap_t) & (gid < n)[:, None]
    gbucket = torch.where(entry_real, tb + goff, nbcap).clamp(0, nbcap - 1)

    rounds = []
    for r in range(cfg.silk_l):
        # 1. bucket-level signatures: local MinHash, a small all-gather
        sig_t = kops.minhash_segments(flat_ids, offsets, table_keys[r])
        sig = all_gather(sig_t, mesh).reshape(-1)[:nbcap]
        # 2. bins, the same on every rank
        bin_of_bucket, bin_nbuckets = bins_from_signatures(sig, bucket_valid)
        # 3. rank-local majority vote on own rows
        ebin = torch.where(entry_real, bin_of_bucket[gbucket], nbcap)
        srt, maj = rowwise_majority(ebin.to(torch.int32), bin_nbuckets, 2)
        core = segment_sum(maj.to(torch.int32).reshape(-1),
                           torch.where(maj, srt, nbcap).reshape(-1), nbcap)
        core_size = psum(core, mesh)
        keep_bin = core_size >= cfg.delta
        new_group_of_bin = torch.cumsum(keep_bin, 0, dtype=torch.int32) - 1
        num_groups = keep_bin.sum().to(torch.int32)
        # 4. local compaction -> all-gather -> the global top pair_cap
        srt_c = srt.clamp(0, nbcap - 1).to(torch.int64)
        out_valid = maj & keep_bin[srt_c]
        out_group = torch.where(out_valid, new_group_of_bin[srt_c], -1)
        out_ids = gid.to(torch.int32)[:, None].expand(srt.shape)
        lg, li, lv, _ = compact_pairs(out_group.reshape(-1),
                                      out_ids.reshape(-1),
                                      out_valid.reshape(-1), cfg.pair_cap)
        rg, ri, rv, _ = compact_pairs(all_gather(lg, mesh).reshape(-1),
                                      all_gather(li, mesh).reshape(-1),
                                      all_gather(lv, mesh).reshape(-1),
                                      cfg.pair_cap)
        total = psum(out_valid.sum().reshape(1), mesh)[0]
        overflow_r = torch.clamp(total - cfg.pair_cap, min=0).to(torch.int32)
        rounds.append(SeedPairs(rg, ri, rv, num_groups, overflow_r))
    return dedup_and_select(rounds, table_keys[cfg.silk_l],
                            pair_cap=cfg.pair_cap, k_max=cfg.k_max)


def discover_sharded(kind: str, parts: tuple, keys: tuple, cfg: GeekConfig,
                     mesh: Mesh, n: int):
    """Stages 1 and 2 of the sharded fit with distributed discovery.

    The sharded peer of ``api.discover`` for the stock ``LSHBucketer`` +
    ``SILKSeeder`` pipeline: rank-local coding, owned-table bucket
    building after one tiled all-to-all, and ``silk_seeding_sharded``.
    ``keys`` is ``LSHBucketer.split_key``'s (tkeys, bkeys, table_keys),
    drawn the same way on every rank and as the in-core fit draws them,
    so the seeds are the in-core fit's. ``parts`` are this rank's rows.

    Returns ``(transform, space_local, seeds, overflow)``: ``space_local``
    is this rank's coded rows, ``seeds`` carry global row ids.
    """
    tkeys, bkeys, table_keys = keys
    transform = fit_transform_sharded(kind, parts, tkeys, cfg, mesh, n)
    space_local = transform(*parts)
    if kind == "dense":
        (a,) = bkeys
        h_local = lsh.qalsh_hash(space_local, a.to(space_local.dtype))
        h_cols = exchange_columns(h_local, mesh, n)          # (n, m_pad/g)
        ids_t, seg_t, b_of_id, sizes = rank_partition_slice(h_cols, cfg.t)
        num_tables, cap_t = cfg.m, cfg.t
    else:
        item_keys, sig_keys = bkeys
        items = lsh.code_items(space_local, item_keys)
        sigs = lsh.minhash_signatures(items, None, sig_keys)  # (L, nl)
        sig_rows = exchange_rows(sigs, mesh, n)               # (L_pad/g, n)
        ids_t, seg_t, b_of_id, sizes = signature_partition_slice(sig_rows)
        num_tables, cap_t = cfg.bucket_l, n
    # mask pad tables before the bucket map goes back to the row owners
    mt = b_of_id.shape[0]
    gt = axis_index(mesh) * mt + torch.arange(mt, device=b_of_id.device)
    b_of_id = torch.where((gt < num_tables)[:, None], b_of_id, cap_t)
    bins_rows = scatter_table_rows(b_of_id, mesh, cap_t,
                                   cfg.compress_collectives)  # (T_pad, nl)
    seeds, overflow = silk_seeding_sharded(
        ids_t, seg_t, sizes, bins_rows, table_keys, cfg, mesh, n=n,
        num_tables=num_tables, cap_t=cap_t)
    return transform, space_local, seeds, overflow


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------

def make_predict_sharded(mesh: Mesh, *, axis: str = "data",
                         probes: int | None = None):
    """The multi-rank serving counterpart of ``model.predict``.

    Returns ``predict_fn(model, *parts) -> (labels, dists)`` taking RAW
    query parts (``(x,)`` dense, ``(x_num, x_cat)`` hetero, ``(sets,
    mask)`` sparse) as global (n, ·) arrays, the same on every rank. Each
    rank codes and assigns its rows with the model's fit-time transform
    and the shared one-pass dispatch, and the outputs are all-gathered:
    global (n,) labels and distances on every rank, bit-identical to
    ``predict(model, model.encode(*parts))`` (rows are independent and
    the model is the same on every rank). With ``probes=p`` each rank
    probes the model's center index for its rows and patches its own
    empty-probe rows with the exact scan (``model.predict(probes=p)``),
    so the result is single-device ``predict(..., probes=p)``'s.
    """
    def predict_fn(model: GeekModel, *parts):
        """Shard the batch, encode and assign each rank's rows, gather."""
        compat.check_device(mesh, model.device, axis)
        full_precision_matmul()
        parts = parts_to_device(parts, model.device)
        present = [p for p in parts if p is not None]
        if not present:
            raise ValueError("every query part is None")
        local, n = _pad_and_shard(present, mesh)
        local_parts = _reinsert_none(local, tuple(p is None for p in parts))
        labels, dists = predict(model, model.encode(*local_parts),
                                probes=probes)
        return (_gather_rows(labels, mesh, n), _gather_rows(dists, mesh, n))

    return predict_fn


# ---------------------------------------------------------------------------
# Table-sync dense fit: the paper's §3.4 MPI design on collectives
# ---------------------------------------------------------------------------

def _assign_l2(x_local, centers, center_valid, cfg: GeekConfig):
    """Local one-pass assignment: the L2 kernel on the card."""
    return kops.distance_argmin_l2(x_local, centers, center_valid,
                                   block=cfg.assign_block)


def _assign_l2_accumulate(x_local, centers, center_valid, cfg: GeekConfig):
    """Assignment + per-cluster partial sums and counts for one Lloyd
    sweep: on the card the accumulating kernel, which adds the sums in the
    same pass over x (no second pass); on the CPU its plain version."""
    return kops.distance_argmin_l2(x_local, centers, center_valid,
                                   accumulate=True, block=cfg.assign_block)


def _refine_all_reduce(psums, pcnt, mesh: Mesh, cfg: GeekConfig):
    """All-reduce one sweep's (k, d) partial sums and (k,) counts.

    With ``cfg.compress_collectives`` the sums ride the int8 quantized
    all-reduce (4x fewer wire bytes); the counts stay an exact sum (they
    divide the sums). Each sweep re-assigns from scratch, so the
    quantization error does not accumulate.
    """
    if cfg.compress_collectives:
        mean, _ = compressed_psum(psums, mesh)
        rsums = mean * axis_size(mesh)
    else:
        rsums = psum(psums, mesh)
    return rsums, psum(pcnt, mesh)


def _quantile_boundaries(h_local: torch.Tensor, t: int, samples: int,
                         mesh: Mesh) -> torch.Tensor:
    """(m, t − 1) global bucket boundaries from an all-gathered stride
    sample of ``samples`` rows per rank."""
    nl, m = h_local.shape
    s = min(samples, nl)
    stride = max(nl // s, 1)
    sample = h_local[::stride][:s].contiguous()
    alls = all_gather(sample, mesh).reshape(-1, m)
    srt = torch.sort(alls, dim=0).values
    q = torch.arange(1, t, device=h_local.device) * srt.shape[0] // t
    return srt[q].T.contiguous()


class TableSyncResult(NamedTuple):
    """What ``fit_dense_sharded`` returns: the reference's 6-tuple."""
    labels: torch.Tensor        # (n,) global after make_fit_dense, or local
    centers: torch.Tensor       # (k_max, d) float32
    center_valid: torch.Tensor  # (k_max,) bool
    k_star: torch.Tensor        # () int32
    radius: torch.Tensor        # (k_max,) float32
    overflow: torch.Tensor      # () int32


def fit_dense_sharded(x_local: torch.Tensor, mesh: Mesh, cfg: GeekConfig, *,
                      a: torch.Tensor, table_keys: torch.Tensor,
                      samples: int = 1024) -> TableSyncResult:
    """Per-rank body of the paper-§3.4 table-sync fit.

    ``x_local`` (n / g, d) is this rank's row block; ``a`` (d, m) and
    ``table_keys`` (silk_l + 1, silk_k, 2) the same on every rank.
    ``cfg.m`` must be a multiple of g: each rank owns m / g whole tables.
    Returns the labels of this rank's rows and, the same on every rank,
    centers, validity, k*, radius and overflow.
    """
    g, rank = axis_size(mesh), axis_index(mesh)
    nl, d = x_local.shape
    m, t = cfg.m, cfg.t
    if m % g:
        raise ValueError(f"cfg.m={m} hash tables must divide over {g} ranks "
                         "(paper §3.4)")
    mt = m // g
    dev = x_local.device

    # -- phase 1: transformation (local hash, quantile partition) ----------
    h = lsh.qalsh_hash(x_local, a.to(x_local.dtype))          # (nl, m)
    bounds = _quantile_boundaries(h, t, samples, mesh)        # (m, t-1)
    bid = torch.searchsorted(bounds, h.T.contiguous(), side="left"
                             ).to(torch.int32)                # (m, nl)

    # -- bucket synchronization: rank j <- whole tables [j*mt, (j+1)*mt) --
    bid_all = all_to_all(bid, mesh, split_axis=0, concat_axis=1)  # (mt, n)
    order = torch.argsort(bid_all, dim=1, stable=True)
    buckets = BucketTables(order.to(torch.int32),
                           torch.gather(bid_all, 1, order),
                           torch.full((mt,), t, dtype=torch.int32, device=dev),
                           t)

    # -- phase 2: SILK on local tables, C_shared all-gather, dedup ----------
    flat_ids, flat_seg = buckets.flatten()
    valid = torch.ones_like(flat_ids, dtype=torch.bool)
    offsets = csr_offsets(flat_seg, mt * t)
    rounds = [silk_round(flat_ids, flat_seg, valid, mt * t, table_keys[r],
                         cfg.delta, 2, cfg.pair_cap, offsets=offsets)
              for r in range(cfg.silk_l)]
    lgroup = torch.cat([torch.where(rd.valid, rd.group + r * cfg.pair_cap, -1)
                        for r, rd in enumerate(rounds)])
    lids = torch.cat([rd.id for rd in rounds])
    lvalid = torch.cat([rd.valid for rd in rounds])
    # C_shared sync (small): the paper's communication-cost trick
    gg, gi, gv = (all_gather(v, mesh) for v in (lgroup, lids, lvalid))
    local_span = cfg.silk_l * cfg.pair_cap
    group_global = torch.where(
        gv, gg + (torch.arange(g, dtype=torch.int32, device=dev)
                  * local_span)[:, None], 0)
    group_cap = g * local_span
    seg = torch.where(gv.reshape(-1), group_global.reshape(-1), group_cap - 1)
    dedup = silk_round(gi.reshape(-1), seg, gv.reshape(-1), group_cap,
                       table_keys[cfg.silk_l], 1, 1, cfg.pair_cap)
    seeds = select_top_groups(dedup, cfg.pair_cap, cfg.k_max)
    overflow = (torch.stack([rd.overflow for rd in rounds]).sum()
                + dedup.overflow).to(torch.int32)

    # -- phase 3: local centroids + all-reduce, one-pass local assignment --
    lo = rank * nl
    sid = seeds.id.to(torch.int64)
    mine = seeds.valid & (sid >= lo) & (sid < lo + nl)
    rel = (sid - lo).clamp(0, nl - 1)
    grp = torch.where(mine, seeds.group.to(torch.int64), cfg.k_max)
    w = mine.to(x_local.dtype)
    sums = assign_mod.segment_sum_rows(x_local[rel] * w[:, None], grp,
                                       cfg.k_max + 1)[:cfg.k_max]
    cnt = torch.bincount(grp, minlength=cfg.k_max + 1)[:cfg.k_max]
    sums = psum(sums, mesh)
    cnt = psum(cnt.to(torch.float32), mesh)
    centers = sums / torch.clamp(cnt, min=1.0)[:, None]
    center_valid = cnt > 0

    # optional Lloyd refinement: each sweep is one fused assign+accumulate
    # pass and an all-reduce of the (k, d) partials
    for _ in range(cfg.refine_sweeps):
        _, _, psums, pcnt = _assign_l2_accumulate(x_local, centers,
                                                  center_valid, cfg)
        rsums, rcnt = _refine_all_reduce(psums, pcnt, mesh, cfg)
        centers = torch.where((rcnt > 0)[:, None],
                              rsums / torch.clamp(rcnt, min=1.0)[:, None],
                              centers)
        center_valid = center_valid & (rcnt > 0)

    labels, d2 = _assign_l2(x_local, centers, center_valid, cfg)
    dists = torch.sqrt(d2)
    radius = pmax(assign_mod.cluster_radius(dists, labels, cfg.k_max), mesh)
    return TableSyncResult(labels, centers, center_valid, seeds.k_star,
                           radius, overflow)


def make_fit_dense(mesh: Mesh, cfg: GeekConfig, *, axis: str = "data",
                   device=None):
    """The table-sync distributed fit (paper §3.4) on ``mesh``.

    Returns ``fn(x, seed, *, a=None, table_keys=None) ->
    TableSyncResult``, called on every rank with the same global (n, d)
    rows (n a multiple of g); each rank fits its own row block on
    ``device`` (as in ``GEEK``: ``None`` is ``cuda``, ``"cpu"`` the plain
    path), whose backend the mesh must have. ``seed``
    (an int or a ``torch.Generator`` on that device) gives, in this
    order and the same on every rank, the (d, m) QALSH matrix ``a``
    (``lsh.qalsh_projections``) and the (silk_l + 1, silk_k, 2) SILK
    ``table_keys`` (``utils.hashing.derive_hash_keys``); either may be
    passed in instead (the parity tests pass the reference's). The
    labels come back global (n,) on every rank; the rest is replicated.
    Raw tensors, not a ``GeekModel``: this is the paper-faithful
    benchmark path, ``GEEK(cfg).fit(data, seed, mesh=...)`` the
    model-producing one.
    """
    dev = resolve_device(device)

    def fn(x, seed, *, a=None, table_keys=None) -> TableSyncResult:
        """Fit the global rows ``x`` on every rank of the mesh."""
        compat.check_device(mesh, dev, axis)
        full_precision_matmul()
        (x,) = parts_to_device((x,), dev)
        n, d = x.shape
        g = axis_size(mesh)
        if n % g:
            raise ValueError(f"{n} rows do not split evenly over {g} ranks")
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(seed)))
        drawn_a = lsh.qalsh_projections(gen, d, cfg.m)
        drawn_keys = derive_hash_keys(gen, (cfg.silk_l + 1, cfg.silk_k))
        a = drawn_a if a is None else torch.as_tensor(a, device=dev)
        table_keys = (drawn_keys if table_keys is None
                      else torch.as_tensor(table_keys, device=dev))
        nl = n // g
        r = axis_index(mesh)
        res = fit_dense_sharded(x[r * nl:(r + 1) * nl], mesh,
                                cfg, a=a.to(torch.float32),
                                table_keys=table_keys.to(torch.int64))
        return res._replace(labels=_gather_rows(res.labels, mesh, None))

    return fn
