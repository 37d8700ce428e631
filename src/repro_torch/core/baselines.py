"""Baselines the paper compares against (§4.1): Lloyd, k-means++ seeding,
random seeding, sampled k-means (FAISS-style 256·k subsample), k-modes.

The counterpart of ``repro.core.baselines``. All share GEEK's assignment
dispatch (``kernels.ops``), so timing comparisons isolate the seeding or
iteration strategy, as in the paper's Figures 5 and 6: on the card the L2
assignments launch the hand-written L2 kernel and the k-modes sweeps the
equality Hamming kernel; on the CPU both take their plain versions.

Randomness is the port's own, from a ``torch.Generator`` on the data's
device (an int seeds one): ``jax.random.choice(replace=False)`` becomes
``torch.randperm(n)[:k]``, the D² draws ``torch.multinomial(p, 1 or l,
replacement=True)``. So one seed gives other seeds than the reference's
key. Each function splits its draws from its deterministic part
(``_lloyd_iterate``, ``_kmodes_iterate``, ``_candidate_weights``,
``_one_pass``), so tests can hand both packages the same draws.

``torch.multinomial`` takes at most 2**24 categories: the D² samplers
raise ``TooManyCategoriesError`` above that. A D² vector that sums to 0
(every point already a seed) takes the reference's path: the sum is
clamped at 1e-30, and the all-zero vector draws row 0, as
``jax.random.choice`` does (its cumulative sum is 0 everywhere); nothing
reads the device on the host to decide it. ``torch.multinomial`` itself
validates a one-sample draw on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import assign as assign_mod
from repro_torch.core.silk import Seeds
from repro_torch.kernels import ops as kops
from repro_torch.utils.device import as_generator, full_precision_matmul

#: the most categories ``torch.multinomial`` samples from
MAX_CATEGORIES = 1 << 24


class TooManyCategoriesError(ValueError):
    """A D² draw over more rows than ``torch.multinomial`` takes (2**24)."""


class KMeansResult(NamedTuple):
    """Baseline clustering output (labels + centers + diagnostics)."""

    labels: torch.Tensor
    dists: torch.Tensor
    centers: torch.Tensor
    center_valid: torch.Tensor
    radius: torch.Tensor
    iters: int


# ---------------------------------------------------------------------------
# Seeding
# ---------------------------------------------------------------------------

def random_indices(n: int, k: int, gen: torch.Generator) -> torch.Tensor:
    """k distinct uniform row indices of n (int64, on ``gen``'s device)."""
    return torch.randperm(n, generator=gen, device=gen.device)[:k]


def random_seeds(x: torch.Tensor, k: int, gen) -> torch.Tensor:
    """k uniformly sampled rows of x (without replacement)."""
    gen = as_generator(gen, x.device)
    return x[random_indices(x.shape[0], k, gen)]


def _check_categories(m: int) -> None:
    if m > MAX_CATEGORIES:
        raise TooManyCategoriesError(
            f"D² sampling over {m:,} rows: torch.multinomial takes at most "
            f"2**24 = {MAX_CATEGORIES:,} categories")


def _d2_draw(weights: torch.Tensor, num: int, gen: torch.Generator
             ) -> torch.Tensor:
    """``num`` indices drawn with replacement in proportion to the
    non-negative ``weights``: the reference's normalisation (sum clamped
    at 1e-30), and an all-zero vector draws index 0, as
    ``jax.random.choice`` does."""
    total = weights.sum()
    probs = weights / torch.clamp(total, min=1e-30)
    probs[0] = probs[0] + (total <= 0).to(probs.dtype)
    return torch.multinomial(probs, num, replacement=True, generator=gen)


def _d2_to(x: torch.Tensor, xsq: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """(n,) squared distances of x's rows to one row c: the reference's
    ``xsq - 2 (x @ c) + |c|²`` (a matvec, outside its kernels)."""
    return xsq - 2.0 * (x @ c) + torch.sum(c * c)


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[0]`` of x, for a (1,) index tensor on x's device: a
    gather, not a host read of the index."""
    return torch.index_select(x, 0, idx)[0]


def _kmeanspp_rounds(x: torch.Tensor, weights: torch.Tensor | None,
                     first: torch.Tensor, k: int, gen: torch.Generator
                     ) -> torch.Tensor:
    """k-means++ D² rounds from the row ``first`` ((1,) int64): k − 1 host
    rounds of a matvec and a draw, nothing read back. ``weights`` scales
    each row's D² (the weighted reduction of k-means‖). Returns (k,)
    int32 row indices."""
    out = torch.empty((k,), dtype=torch.int64, device=x.device)
    out[:1] = first
    xsq = torch.sum(x * x, dim=-1)
    d2 = _d2_to(x, xsq, _row(x, first))
    for i in range(1, k):
        probs = torch.clamp(d2, min=0.0)
        if weights is not None:
            probs = probs * weights
        idx = _d2_draw(probs, 1, gen)
        out[i:i + 1] = idx
        d2 = torch.minimum(d2, _d2_to(x, xsq, _row(x, idx)))
    return out.to(torch.int32)


def kmeanspp_indices(x: torch.Tensor, k: int, gen) -> torch.Tensor:
    """k-means++ D² sampling (Arthur & Vassilvitskii '07), returning ROW
    INDICES into x: the index form the ``Seeds`` contract needs.

    Parameters
    ----------
    x : (n, d) float32 tensor
        Dense rows (Euclidean space), n ≤ 2**24.
    k : int
        Number of seeds to draw.
    gen : torch.Generator or int
        Source of the draws (on x's device; an int seeds one).

    Returns
    -------
    torch.Tensor
        (k,) int32 row indices of the chosen seed points.
    """
    full_precision_matmul()
    gen = as_generator(gen, x.device)
    n = x.shape[0]
    _check_categories(n)
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    return _kmeanspp_rounds(x, None, first, k, gen)


def kmeanspp_seeds(x: torch.Tensor, k: int, gen) -> torch.Tensor:
    """k-means++ D² sampling: O(ndk), k sequential rounds."""
    return x[kmeanspp_indices(x, k, gen).to(torch.int64)]


def _weighted_kmeanspp(cand: torch.Tensor, w: torch.Tensor, k: int,
                       gen: torch.Generator) -> torch.Tensor:
    """Weighted k-means++ over a candidate set; returns candidate indices.

    The reduction step of k-means‖: each candidate's D² contribution is
    scaled by its weight (the number of data points it represents), and
    the first candidate is drawn in proportion to the weights.
    """
    _check_categories(cand.shape[0])
    wf = w.to(cand.dtype)
    first = _d2_draw(wf, 1, gen)
    return _kmeanspp_rounds(cand, wf, first, k, gen)


def _candidate_weights(x: torch.Tensor, cand_idx: torch.Tensor,
                       block: int = 4096) -> torch.Tensor:
    """(C,) int32 counts of the rows of x nearest each candidate row
    ``x[cand_idx]`` (first index on ties, so a duplicate candidate keeps
    weight 0): the assignment kernel, then an integer count."""
    cvec = x[cand_idx.to(torch.int64)]
    nearest, _ = kops.distance_argmin_l2(
        x, cvec, torch.ones((cvec.shape[0],), dtype=torch.bool,
                            device=x.device), block=block)
    return torch.bincount(nearest.to(torch.int64),
                          minlength=cvec.shape[0]).to(torch.int32)


def scalable_kmeanspp_indices(x: torch.Tensor, k: int, gen, *,
                              rounds: int = 5,
                              oversample: int | None = None,
                              block: int = 4096) -> torch.Tensor:
    """k-means‖ (Bahmani et al. '12) seeding, returning ROW INDICES.

    Each of ``rounds`` rounds draws ``oversample`` points at once
    (D²-proportional, with replacement) and tightens every row's D² with
    one assignment pass against them; the ~``rounds · oversample``
    candidates are weighted by how many rows they attract
    (``_candidate_weights``) and reduced to k by weighted k-means++.
    Rounds, not k, sequential passes over x.

    Parameters
    ----------
    x : (n, d) float32 tensor
        Dense rows, n ≤ 2**24.
    k : int
        Number of seeds to produce.
    gen : torch.Generator or int
        Source of the draws (on x's device).
    rounds : int
        Oversampling rounds (~5 in practice).
    oversample : int or None
        Points drawn a round (default 2k).
    block : int
        Rows a step of the CPU's plain assignment.

    Returns
    -------
    torch.Tensor
        (k,) int32 row indices of the chosen seed points.
    """
    full_precision_matmul()
    gen = as_generator(gen, x.device)
    n = x.shape[0]
    _check_categories(n)
    l = 2 * k if oversample is None else int(oversample)
    xsq = torch.sum(x * x, dim=-1)
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    d2 = _d2_to(x, xsq, _row(x, first))
    cand = [first]
    for _ in range(rounds):
        idx = _d2_draw(torch.clamp(d2, min=0.0), l, gen)
        cand.append(idx)
        _, d2_new = kops.distance_argmin_l2(
            x, x[idx], torch.ones((l,), dtype=torch.bool, device=x.device),
            block=block)
        d2 = torch.minimum(d2, d2_new)
    cand_idx = torch.cat(cand)                       # (1 + rounds·l,)
    w = _candidate_weights(x, cand_idx, block)
    chosen = _weighted_kmeanspp(x[cand_idx], w, k, gen)
    return cand_idx[chosen.to(torch.int64)].to(torch.int32)


# ---------------------------------------------------------------------------
# Lloyd iterations (Euclidean)
# ---------------------------------------------------------------------------

def _one_pass(x: torch.Tensor, centers: torch.Tensor,
              center_valid: torch.Tensor, block: int, iters: int
              ) -> KMeansResult:
    """One assignment pass against fixed centers: labels, Euclidean
    distances, radius."""
    labels, d2 = kops.distance_argmin_l2(x, centers, center_valid,
                                         block=block)
    dists = torch.sqrt(d2)
    radius = assign_mod.cluster_radius(dists, labels, centers.shape[0])
    return KMeansResult(labels, dists, centers, center_valid, radius, iters)


def _lloyd_iterate(x: torch.Tensor, centers: torch.Tensor, iters: int,
                   block: int = 4096) -> KMeansResult:
    """``iters`` Lloyd sweeps from the given centers, then one pass.

    A sweep assigns every row, then each center becomes the mean of its
    rows (sums in row order, ``assign.segment_sum_rows``: no float
    atomics); a center with no row keeps its place and turns invalid.
    """
    full_precision_matmul()
    k = centers.shape[0]
    valid = torch.ones((k,), dtype=torch.bool, device=x.device)
    for _ in range(iters):
        labels, _ = kops.distance_argmin_l2(x, centers, valid, block=block)
        sums = assign_mod.segment_sum_rows(x, labels, k).to(x.dtype)
        cnt = torch.bincount(labels.to(torch.int64),
                             minlength=k)[:k].to(x.dtype)
        new = sums / torch.clamp(cnt, min=1.0)[:, None]
        valid = cnt > 0
        centers = torch.where(valid[:, None], new, centers)
    return _one_pass(x, centers, valid, block, iters)


def lloyd(x: torch.Tensor, k: int, gen, *, iters: int = 25,
          init: str = "random", block: int = 4096) -> KMeansResult:
    """Lloyd's k-means: ``iters`` full assign + update sweeps from
    ``init`` ("random" or "kmeans++") seeds."""
    gen = as_generator(gen, x.device)
    if init == "random":
        centers = random_seeds(x, k, gen)
    elif init == "kmeans++":
        centers = kmeanspp_seeds(x, k, gen)
    else:
        raise ValueError(init)
    return _lloyd_iterate(x, centers, iters, block)


def sampled_kmeans(x: torch.Tensor, k: int, gen, *, iters: int = 25,
                   sample_per_k: int = 256, block: int = 4096
                   ) -> KMeansResult:
    """FAISS-style: Lloyd on a uniform ``sample_per_k · k`` subsample, then
    one full assignment pass (the paper's Sift1B comparison)."""
    gen = as_generator(gen, x.device)
    n = x.shape[0]
    s = min(sample_per_k * k, n)
    sub = lloyd(x[random_indices(n, s, gen)], k, gen, iters=iters,
                block=block)
    return _one_pass(x, sub.centers, sub.center_valid, block, iters)


# ---------------------------------------------------------------------------
# k-modes (categorical codes, Huang '98): the hetero / sparse baseline
# ---------------------------------------------------------------------------

def _kmodes_iterate(codes: torch.Tensor, centers: torch.Tensor, iters: int,
                    block: int = 4096) -> KMeansResult:
    """``iters`` k-modes sweeps from the given mode centers, then one pass.

    A sweep assigns every row by mismatch count, then each center becomes
    its rows' per-attribute modes (``assign.mode_centers`` over every row
    as a member of its label's group: ties to the smallest code); a center
    with no row keeps its codes and turns invalid. Integer throughout, so
    the result is the reference's bit for bit on the same centers.
    Distances are mismatch fractions (counts / d).
    """
    codes = codes.to(torch.int32)
    centers = centers.to(torch.int32)
    n, d = codes.shape
    k = centers.shape[0]
    dev = codes.device
    valid = torch.ones((k,), dtype=torch.bool, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    every = torch.ones((n,), dtype=torch.bool, device=dev)
    k_star = torch.tensor(k, dtype=torch.int32, device=dev)
    for _ in range(iters):
        labels, _ = kops.distance_argmin_hamming(codes, centers, valid,
                                                 block=block)
        new, valid = assign_mod.mode_centers(
            codes, Seeds(group=labels, id=ids, valid=every, k_star=k_star,
                         k_max=k))
        centers = torch.where(valid[:, None], new, centers)
    labels, counts = kops.distance_argmin_hamming(codes, centers, valid,
                                                  block=block)
    dists = counts / d
    radius = assign_mod.cluster_radius(dists, labels, k)
    return KMeansResult(labels, dists, centers, valid, radius, iters)


def kmodes(codes: torch.Tensor, k: int, gen, *, iters: int = 10,
           block: int = 4096) -> KMeansResult:
    """k-modes (Huang '98) over categorical codes: Hamming Lloyd from k
    distinct uniformly drawn rows."""
    gen = as_generator(gen, codes.device)
    centers = codes[random_indices(codes.shape[0], k, gen)]
    return _kmodes_iterate(codes, centers, iters, block)


# ---------------------------------------------------------------------------
# Seeding-only entry point (paper Figure 6: seed, then ONE assignment pass)
# ---------------------------------------------------------------------------

def seed_then_assign(x: torch.Tensor, k: int, gen, *,
                     method: str = "kmeans++", block: int = 4096
                     ) -> KMeansResult:
    """Seed with ``method`` ("kmeans++", "scalable-kmeans++" or
    "random"), then ONE assignment pass (paper Figure 6): the seeding
    cost plus the pass GEEK pays. ``GEEK(cfg,
    seeder=KMeansPPSeeder(k)).fit(DenseData(x), seed)`` gives the same
    labels and distances bit for bit on one device (``core.api``)."""
    gen = as_generator(gen, x.device)
    if method == "kmeans++":
        idx = kmeanspp_indices(x, k, gen)
    elif method == "scalable-kmeans++":
        idx = scalable_kmeanspp_indices(x, k, gen, block=block)
    elif method == "random":
        idx = random_indices(x.shape[0], k, gen)
    else:
        raise ValueError(method)
    valid = torch.ones((k,), dtype=torch.bool, device=x.device)
    return _one_pass(x, x[idx.to(torch.int64)], valid, block, 0)
