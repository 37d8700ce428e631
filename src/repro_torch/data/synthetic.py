"""Synthetic data with known cluster structure, drawn on the device.

The counterpart of ``repro.data.synthetic``, shaped after the paper's
Table 2 corpora: GIST- and SIFT-like dense vectors, GeoNames-like
heterogeneous rows (numeric + categorical) and URL-like sparse sets. The
draws come
from a ``torch.Generator`` on the device the data is made on, so a
large set needs no host-to-device copy. The same seed gives other
numbers than the reference's ``jax.random`` draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DenseBlobs(NamedTuple):
    x: torch.Tensor            # (n, d)
    true_labels: torch.Tensor  # (n,) int32


class HeteroBlobs(NamedTuple):
    x_num: torch.Tensor        # (n, d_num) float32
    x_cat: torch.Tensor        # (n, d_cat) int32
    true_labels: torch.Tensor  # (n,) int32


class SparseSets(NamedTuple):
    sets: torch.Tensor         # (n, s) int32 item ids
    mask: torch.Tensor         # (n, s) bool
    true_labels: torch.Tensor  # (n,) int32


def dense_blobs(gen: torch.Generator, n: int, d: int, k: int, *,
                spread: float = 0.08, dtype=torch.float32) -> DenseBlobs:
    """k Gaussian blobs: N(0, 1) centers, N(0, spread²) noise, on
    ``gen.device``."""
    dev = gen.device
    centers = torch.randn((k, d), generator=gen, device=dev, dtype=dtype)
    labels = torch.randint(0, k, (n,), generator=gen, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev, dtype=dtype)
    x.mul_(spread).add_(centers[labels])   # in place: one (n, d) buffer
    return DenseBlobs(x, labels.to(torch.int32))


def gist_like(gen: torch.Generator, n: int = 4096, k: int = 32) -> DenseBlobs:
    """GIST-shaped blobs: d = 960 (the GIST1M descriptors' width)."""
    return dense_blobs(gen, n, 960, k)


def sift_like(gen: torch.Generator, n: int = 8192, k: int = 64) -> DenseBlobs:
    """SIFT-shaped blobs: d = 128 (ANN_SIFT1M's width)."""
    return dense_blobs(gen, n, 128, k)


def geonames_like(gen: torch.Generator, n: int = 8192, k: int = 32,
                  d_num: int = 5, d_cat: int = 4, card: int = 12
                  ) -> HeteroBlobs:
    """GeoNames-shaped rows: d_num Gaussian numeric columns around N(0, 1)
    cluster centers (noise 0.05) and d_cat categories in [0, card), each
    the cluster's own with probability 0.9, else uniform."""
    dev = gen.device
    labels = torch.randint(0, k, (n,), generator=gen, device=dev)
    num_centers = torch.randn((k, d_num), generator=gen, device=dev)
    x_num = num_centers[labels] + 0.05 * torch.randn((n, d_num), generator=gen,
                                                     device=dev)
    cat_centers = torch.randint(0, card, (k, d_cat), generator=gen, device=dev)
    flip = torch.rand((n, d_cat), generator=gen, device=dev) < 0.1
    rand_cat = torch.randint(0, card, (n, d_cat), generator=gen, device=dev)
    x_cat = torch.where(flip, rand_cat, cat_centers[labels])
    return HeteroBlobs(x_num.to(torch.float32), x_cat.to(torch.int32),
                       labels.to(torch.int32))


def url_like(gen: torch.Generator, n: int = 4096, k: int = 32, nnz: int = 32,
             universe: int = 3_200_000, shared_frac: float = 0.75
             ) -> SparseSets:
    """URL-shaped sets of ``nnz`` items from ``universe``: each cluster
    has a core item set, and a member keeps each core item with
    probability ``shared_frac``, else draws one uniformly."""
    dev = gen.device
    labels = torch.randint(0, k, (n,), generator=gen, device=dev)
    core = torch.randint(0, universe, (k, nnz), generator=gen, device=dev,
                         dtype=torch.int32)
    keep = torch.rand((n, nnz), generator=gen, device=dev) < shared_frac
    sets = torch.randint(0, universe, (n, nnz), generator=gen, device=dev,
                         dtype=torch.int32)
    sets = torch.where(keep, core[labels], sets)   # one (n, nnz) int32 buffer
    return SparseSets(sets, torch.ones((n, nnz), dtype=torch.bool, device=dev),
                      labels.to(torch.int32))
