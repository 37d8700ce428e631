"""GEEK — shared configuration, per-run result, and the dense seeding
helper (the counterpart of ``repro.core.geek``).

    data  --[QALSH]-->  buckets
    buckets --[SILK]--> seed groups (k* discovered, not pre-specified)
    seeds --[centroids + ONE assignment pass]--> clusters
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import assign as assign_mod
from repro_torch.core.model import build_model
from repro_torch.core.silk import Seeds
from repro_torch.core.transform import IdentityTransform


@dataclasses.dataclass(frozen=True)
class GeekConfig:
    """The reference's configuration, field for field, so that
    ``GeekConfig(**dataclasses.asdict(repro_cfg))`` carries one over.
    The port reads the dense fields; the rest wait for their modes."""
    # -- data transformation (paper §3.1) --
    m: int = 40            # QALSH hash tables (homogeneous dense)
    t: int = 64            # buckets per QALSH table (granularity knob)
    bucket_k: int = 3      # K for MinHash (K, L) bucketing (hetero/sparse)
    bucket_l: int = 20     # L for MinHash (K, L) bucketing
    t_cat: int = 16        # discretization bins for numeric attributes
    doph_m: int = 64       # DOPH output dimensionality (sparse)
    # -- SILK (paper §3.2) --
    silk_k: int = 3        # K (paper default)
    silk_l: int = 5        # L for SILK rounds
    delta: int = 10        # seeding threshold
    # -- static shape budgets --
    k_max: int = 1024      # max seed groups kept (top-k_max by size)
    pair_cap: int = 1 << 16
    # -- assignment --
    assign_block: int = 4096  # row block of the plain (CPU) assignment
    use_pallas: bool = False  # metadata only: the device picks the route
    hamming_impl: str = "auto"
    code_bits: int = 0
    refine_sweeps: int = 0
    compress_collectives: bool = False
    gather_cap_bytes: int = 1 << 31


class GeekResult(NamedTuple):
    labels: torch.Tensor        # (n,) int32
    dists: torch.Tensor         # (n,) distance to assigned center
    centers: torch.Tensor       # (k_max, d) centroids
    center_valid: torch.Tensor  # (k_max,) bool
    k_star: torch.Tensor        # () int32 — discovered #clusters
    radius: torch.Tensor        # (k_max,) per-cluster max distance
    seeds: Seeds
    overflow: torch.Tensor      # () int32 — static-budget truncation


def _seed_dense(x, seeds: Seeds, cfg: GeekConfig, *, transform=None,
                bucketer_id: str = "", seeder_id: str = ""):
    """Centers + model for a dense fit — everything but the n-sized pass."""
    centers, cvalid = assign_mod.centroid_centers(x, seeds)
    model = build_model(centers, cvalid, seeds.k_star,
                        torch.zeros((cfg.k_max,), dtype=torch.float32,
                                    device=x.device),
                        metric="l2", assign_block=cfg.assign_block,
                        use_pallas=cfg.use_pallas,
                        transform=(IdentityTransform() if transform is None
                                   else transform),
                        bucketer_id=bucketer_id, seeder_id=seeder_id)
    return centers, cvalid, model
