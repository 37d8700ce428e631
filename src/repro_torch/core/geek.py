"""GEEK — shared configuration, per-run result, and the kind-specific
helpers the stage protocols are built from (the counterpart of
``repro.core.geek``).

    data  --[LSH family for the data's metric]-->  buckets
    buckets --[SILK]--> seed groups (k* discovered, not pre-specified)
    seeds --[central vectors + ONE assignment pass]--> clusters
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import assign as assign_mod
from repro_torch.core.model import NumericDiscretizer, build_model
from repro_torch.core.silk import Seeds
from repro_torch.core.transform import (HeteroTransform, IdentityTransform,
                                        SparseTransform)
from repro_torch.kernels.pack import bits_for_cardinality


@dataclasses.dataclass(frozen=True)
class GeekConfig:
    """The reference's configuration, field for field, so that
    ``GeekConfig(**dataclasses.asdict(repro_cfg))`` carries one over.
    ``refine_sweeps`` and ``compress_collectives`` serve the table-sync
    fit (``core.distributed.make_fit_dense``; ``compress_collectives``
    also narrows the sharded fit's bucket-map exchange), and
    ``gather_cap_bytes`` bounds the sharded fit's gathered discovery."""
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
    # Hamming assignment: "equality" (int32 codes), "packed" (bit-packed
    # words, needs code_bits), "onehot" (one-hot product, code_bits <= 8),
    # "auto" (packed when a static code width is known, else equality)
    hamming_impl: str = "auto"
    code_bits: int = 0     # static bound on hetero code width (0: unknown;
                           # sparse DOPH codes are always 16 bits)
    refine_sweeps: int = 0
    compress_collectives: bool = False
    gather_cap_bytes: int = 1 << 31


class GeekResult(NamedTuple):
    labels: torch.Tensor        # (n,) int32
    dists: torch.Tensor         # (n,) distance to assigned center
    centers: torch.Tensor       # (k_max, d) centroids or int32 modes
    center_valid: torch.Tensor  # (k_max,) bool
    k_star: torch.Tensor        # () int32 — discovered #clusters
    radius: torch.Tensor        # (k_max,) per-cluster max distance
    seeds: Seeds
    overflow: torch.Tensor      # () int32 — static-budget truncation


def resolve_hamming_impl(cfg: GeekConfig, bits: int) -> tuple[str, int]:
    """Resolve ``cfg.hamming_impl`` ("auto" included) and a static code
    width bound into the (impl, bits) pair that fit and predict share."""
    impl = cfg.hamming_impl
    if impl == "auto":
        impl = "packed" if 0 < bits < 32 else "equality"
    if impl in ("packed", "onehot") and not 0 < bits <= 32:
        raise ValueError(f"hamming_impl={impl!r} needs a static code width; "
                         "set GeekConfig.code_bits")
    if impl == "onehot" and bits > 8:
        raise ValueError("one-hot Hamming needs code_bits <= 8 "
                         f"(got {bits}: one-hot width d * 2**bits)")
    if impl == "packed":
        bits = bits_for_cardinality(1 << bits)  # round up to a packable width
    return impl, bits


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


def _seed_codes(codes, seeds: Seeds, cfg: GeekConfig, *, bits: int,
                transform, bucketer_id: str = "", seeder_id: str = ""):
    """Mode centers + model for a code-space fit — everything but the
    n-sized pass. ``bits`` is a static code-width bound (0 = unknown);
    every impl gives the equality path's counts, so the choice is one of
    speed only."""
    centers, cvalid = assign_mod.mode_centers(codes, seeds)
    impl, bits = resolve_hamming_impl(cfg, bits)
    return build_model(centers, cvalid, seeds.k_star,
                       torch.zeros((cfg.k_max,), dtype=torch.float32,
                                   device=codes.device),
                       metric="hamming", impl=impl, code_bits=bits,
                       assign_block=cfg.assign_block,
                       use_pallas=cfg.use_pallas, transform=transform,
                       bucketer_id=bucketer_id, seeder_id=seeder_id)


# ---------------------------------------------------------------------------
# Heterogeneous rows (Algorithm 2)
# ---------------------------------------------------------------------------

def make_hetero_transform(x_num: torch.Tensor | None,
                          t_cat: int) -> HeteroTransform:
    """Fit the persistent hetero transform: per-attribute quantile
    boundaries from the fit batch (none without numeric columns)."""
    disc = (NumericDiscretizer.fit(x_num, t_cat)
            if x_num is not None and x_num.shape[1] > 0 else None)
    return HeteroTransform(disc)


def hetero_codes(x_num: torch.Tensor | None, x_cat: torch.Tensor | None,
                 t_cat: int, *, transform: HeteroTransform | None = None
                 ) -> torch.Tensor:
    """Unified codes: discretized numeric ++ raw categorical. With
    ``transform`` (a fitted model's) the persisted boundaries code the
    batch; without, boundaries are fitted from this batch."""
    if transform is None:
        transform = make_hetero_transform(x_num, t_cat)
    return transform(x_num, x_cat)


def hetero_code_bits(cfg: GeekConfig, x_cat: torch.Tensor | None) -> int:
    """Static hetero code-width bound, validated.

    Numeric-only data codes t_cat bins, so the width is known, and a
    ``cfg.code_bits`` too narrow for t_cat raises rather than mask codes
    in packing. With categorical columns ``cfg.code_bits`` is taken on
    trust.
    """
    bits = cfg.code_bits
    if x_cat is None or x_cat.shape[1] == 0:
        need = bits_for_cardinality(cfg.t_cat)
        if bits == 0:
            bits = need
        elif bits < need:
            raise ValueError(
                f"GeekConfig.code_bits={bits} cannot hold t_cat={cfg.t_cat} "
                f"discretization bins (needs >= {need}); packing would "
                "silently mask codes")
    return bits


# ---------------------------------------------------------------------------
# Sparse sets (Algorithm 3)
# ---------------------------------------------------------------------------

def make_sparse_transform(doph_key: torch.Tensor,
                          cfg: GeekConfig) -> SparseTransform:
    """The persistent sparse transform under the raw (2,) DOPH key
    (``LSHBucketer.split_key`` draws it; the reference splits it from its
    fit key)."""
    return SparseTransform(doph_key, cfg.doph_m)


def sparse_codes(sets: torch.Tensor, mask: torch.Tensor,
                 doph_key: torch.Tensor, cfg: GeekConfig) -> torch.Tensor:
    """16-bit DOPH codes, as the sparse fit codes its rows. Serving
    should prefer ``model.encode(sets, mask)``."""
    return make_sparse_transform(doph_key, cfg)(sets, mask)
