"""Synthetic dense data with known cluster structure, drawn on the device.

The counterpart of ``repro.data.synthetic``'s dense generators. The
draws come from a ``torch.Generator`` on the device the data is made
on, so a large set needs no host-to-device copy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DenseBlobs(NamedTuple):
    x: torch.Tensor            # (n, d)
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


def sift_like(gen: torch.Generator, n: int = 8192, k: int = 64) -> DenseBlobs:
    """SIFT-shaped blobs: d = 128 (ANN_SIFT1M's width)."""
    return dense_blobs(gen, n, 128, k)
