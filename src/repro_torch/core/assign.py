"""Central vectors + one-pass data assignment (paper §3.3), L2 part.

The counterpart of ``repro.core.assign``. The O(n·d·k) assignment runs
through ``kernels.ops.distance_argmin_l2``: the hand-written kernel on
the card, ``assign_l2`` below (the row-blocked plain version) on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.silk import Seeds


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
    order = torch.argsort(g, stable=True)
    cnt_all = torch.bincount(g, minlength=k_max + 1)
    rows = x[seeds.id.to(torch.int64)[order]]
    sums = torch.segment_reduce(rows, "sum", lengths=cnt_all, axis=0)[:k_max]
    cnt = cnt_all[:k_max].to(x.dtype)
    centers = sums / torch.clamp(cnt, min=1.0)[:, None]
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
