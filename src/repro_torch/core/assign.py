"""Central vectors + one-pass data assignment (paper §3.3).

The counterpart of ``repro.core.assign``. Central vectors are centroids
for dense data and per-attribute modes for hetero and sparse codes. The
O(n·d·k) assignment runs through ``kernels.ops``: the hand-written
kernels on the card (L2, equality Hamming, packed Hamming), the
row-blocked plain versions below on the CPU. The one-hot Hamming path is
a plain product on every device, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.silk import Seeds, lexsort
from repro_torch.kernels.pack import field_mismatch_count, onehot_codes
from repro_torch.utils.hashing import run_starts

INT32_MAX = 2**31 - 1


def centroid_centers(x: torch.Tensor, seeds: Seeds
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(k_max, d) centroids + (k_max,) validity from seed-group members.

    The member sums are a deterministic segmented reduction (stable sort
    by group, then one ordered sum per segment), never float atomics, so
    two fits on the card give the same centers; within a group members
    are summed in seed order, as ``segment_sum`` does on the CPU.
    """
    k_max = seeds.k_max
    g = torch.where(seeds.valid, seeds.group, k_max).to(torch.int64)
    sums = segment_sum_rows(x[seeds.id.to(torch.int64)], g,
                            k_max + 1)[:k_max].to(x.dtype)
    cnt = torch.bincount(g, minlength=k_max + 1)[:k_max].to(x.dtype)
    centers = sums / torch.clamp(cnt, min=1.0)[:, None]
    return centers, cnt > 0


def mode_centers(codes: torch.Tensor, seeds: Seeds, *, attr_chunk: int = 64
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(k_max, d) int32 per-attribute modes + (k_max,) validity, by sorting.

    For each (group, attribute) cell the mode is the value with the most
    members, ties to the smallest value. Only valid seed slots enter the
    sort: in the reference invalid slots sort last and count nothing, so
    leaving them out changes no mode. Attributes go ``attr_chunk`` at a
    time, fewer when the seed slots are many (at most 2**26 sort keys per
    chunk); the modes do not depend on the chunking.
    """
    k_max = seeds.k_max
    d = codes.shape[1]
    dev = codes.device
    sel = seeds.valid.nonzero().flatten()
    g = seeds.group[sel].to(torch.int64)                  # (Cv,) in [0, k_max)
    member_codes = codes[seeds.id[sel].to(torch.int64)].to(torch.int32)
    cnt = torch.bincount(g, minlength=k_max)[:k_max]
    cv = g.shape[0]
    step = max(1, min(attr_chunk, (1 << 26) // max(cv, 1)))
    out = []
    for a0 in range(0, d, step):
        w = min(a0 + step, d) - a0
        vals = member_codes[:, a0:a0 + w].T.reshape(-1)   # (w*Cv,)
        cell = (torch.arange(w, dtype=torch.int64, device=dev)[:, None] * k_max
                + g[None, :]).reshape(-1)                 # attr*k_max + group
        order = lexsort((vals, cell))
        cell_s, val_s = cell[order], vals[order]
        starts = run_starts(cell_s, val_s)
        run_id = torch.cumsum(starts, 0) - 1
        run_len = torch.bincount(run_id, minlength=1)
        run_cnt = torch.where(starts, run_len[run_id], 0)
        ncells = w * k_max
        best_cnt = torch.zeros((ncells,), dtype=run_cnt.dtype, device=dev
                               ).scatter_reduce(0, cell_s, run_cnt, "amax")
        is_best = starts & (run_cnt == best_cnt[cell_s]) & (run_cnt > 0)
        mode = torch.full((ncells,), INT32_MAX, dtype=torch.int32, device=dev
                          ).scatter_reduce(0, cell_s,
                                           torch.where(is_best, val_s, INT32_MAX),
                                           "amin")
        out.append(mode.view(w, k_max).T)                 # (k_max, w)
    centers = torch.cat(out, dim=1)
    centers = torch.where((cnt > 0)[:, None], centers, 0)
    return centers, cnt > 0


def assign_l2(x: torch.Tensor, centers: torch.Tensor,
              center_valid: torch.Tensor, *, block: int = 4096
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid under Euclidean distance, in row blocks of
    ``block``. Returns (labels int32, squared distances clamped >= 0)."""
    csq = torch.sum(centers * centers, dim=-1)
    inf = torch.finfo(x.dtype).max
    labels, dists = [], []
    for r0 in range(0, x.shape[0], block):
        xb = x[r0:r0 + block]
        xsq = torch.sum(xb * xb, dim=-1, keepdim=True)
        d2 = xsq - 2.0 * (xb @ centers.T) + csq[None, :]
        d2 = torch.where(center_valid[None, :], d2, inf)
        mind, lab = torch.min(d2, dim=-1)
        labels.append(lab.to(torch.int32))
        dists.append(torch.clamp(mind, min=0.0))
    if not labels:
        return (torch.empty((0,), dtype=torch.int32, device=x.device),
                torch.empty((0,), dtype=x.dtype, device=x.device))
    return torch.cat(labels), torch.cat(dists)


def segment_sum_rows(x: torch.Tensor, seg: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """(k, d) float32 sums of the rows of ``x`` by segment id ``seg`` in
    [0, k): a stable sort by segment, then one ordered sum per segment,
    so each segment's rows are added in row order, never by float
    atomics (the same result on every call)."""
    seg = seg.to(torch.int64)
    order = torch.argsort(seg, stable=True)
    lengths = torch.bincount(seg, minlength=k)
    return torch.segment_reduce(x.to(torch.float32)[order], "sum",
                                lengths=lengths, axis=0)


def assign_l2_with_partials(x: torch.Tensor, centers: torch.Tensor,
                            center_valid: torch.Tensor, *, block: int = 4096):
    """``assign_l2`` plus per-cluster float32 partial sums (k, d) and
    counts (k,): one Lloyd sweep's local work, the plain version of the
    fused ``accumulate=True`` kernel (``kernels.ops.distance_argmin_l2``).
    Returns (labels, d2, sums, counts)."""
    lab, d2 = assign_l2(x, centers, center_valid, block=block)
    k = centers.shape[0]
    sums = segment_sum_rows(x, lab, k)
    cnt = torch.bincount(lab.to(torch.int64), minlength=k).to(torch.float32)
    return lab, d2, sums, cnt


def _blocked_argmin(dist_of, x: torch.Tensor, big: int, valid: torch.Tensor,
                    block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row blocks of ``dist_of(xb)`` (int (b, k) counts): invalid centers
    count ``big``; first index on ties. Returns (labels int32, counts as
    float32), as the reference's jnp paths do."""
    labels = [torch.empty((0,), dtype=torch.int32, device=x.device)]
    dists = [torch.empty((0,), dtype=torch.float32, device=x.device)]
    for r0 in range(0, x.shape[0], block):
        dist = torch.where(valid[None, :], dist_of(x[r0:r0 + block]), big)
        mind, lab = torch.min(dist, dim=-1)
        labels.append(lab.to(torch.int32))
        dists.append(mind.to(torch.float32))
    return torch.cat(labels), torch.cat(dists)


def assign_hamming(codes: torch.Tensor, centers: torch.Tensor,
                   center_valid: torch.Tensor, *, block: int = 4096
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest center under attribute-mismatch count (≈ 1 − Jaccard on
    minwise codes). Invalid centers count d + 1, so with no valid center
    the label is 0 and the count d + 1. Returns (labels int32, mismatch
    counts float32)."""
    d = codes.shape[1]

    def dist_of(xb):
        return d - (xb[:, None, :] == centers[None, :, :]).sum(
            dim=-1, dtype=torch.int32)

    return _blocked_argmin(dist_of, codes, d + 1, center_valid, block)


def assign_hamming_packed(packed: torch.Tensor, packed_centers: torch.Tensor,
                          center_valid: torch.Tensor, *, bits: int,
                          d: int | None = None, block: int = 4096
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``assign_hamming`` on bit-packed codes (``kernels.pack``): XOR +
    field collapse + popcount over the uint32 words, counts equal
    to the unpacked path's. Invalid centers count ``d + 1`` when the
    unpacked width ``d`` is given, else int32 max."""
    big = INT32_MAX if d is None else d + 1

    def dist_of(xb):
        z = xb[:, None, :] ^ packed_centers[None, :, :]
        return field_mismatch_count(z, bits).sum(dim=-1, dtype=torch.int32)

    return _blocked_argmin(dist_of, packed, big, center_valid, block)


def assign_hamming_onehot(codes: torch.Tensor, centers: torch.Tensor,
                          center_valid: torch.Tensor, *, card: int,
                          block: int = 4096,
                          centers_onehot: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``assign_hamming`` for low-cardinality codes: matches are
    ``x1h @ c1h.T`` over one-hot rows.

    The reference multiplies bf16 one-hots with float32 accumulation. A
    torch bf16 product returns bf16, which holds integers exactly only up
    to 256, so both sides go to float32 (0 and 1 are exact, and so is
    every sum below 2**24; TF32 is off, see ``predict``).
    ``centers_onehot`` is the model's cached one-hot of ``centers``.
    """
    d = codes.shape[1]
    c1h = (onehot_codes(centers, card) if centers_onehot is None
           else centers_onehot).to(torch.float32)

    def dist_of(xb):
        matches = onehot_codes(xb, card, dtype=torch.float32) @ c1h.T
        return d - matches.to(torch.int32)

    return _blocked_argmin(dist_of, codes, d + 1, center_valid, block)


def cluster_radius(dists: torch.Tensor, labels: torch.Tensor,
                   k_max: int) -> torch.Tensor:
    """Per-cluster max point-center distance; empty clusters report 0."""
    out = torch.zeros((k_max,), dtype=dists.dtype, device=dists.device)
    return out.scatter_reduce(0, labels.to(torch.int64), dists, "amax",
                              include_self=True)


def cluster_sizes(labels: torch.Tensor, k_max: int) -> torch.Tensor:
    """Points per cluster, (k_max,) int32."""
    return torch.bincount(labels.to(torch.int64),
                          minlength=k_max)[:k_max].to(torch.int32)
