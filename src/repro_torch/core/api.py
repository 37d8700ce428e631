"""One estimator facade + pluggable stage protocols.

The counterpart of ``repro.core.api``::

    from repro_torch import GEEK, DenseData, HeteroData, SparseData, predict
    from repro_torch.utils.compat import make_mesh

    est = GEEK(GeekConfig(k_max=256))            # runs on cuda
    model = est.fit(DenseData(x), 0)             # seed or torch.Generator
    model = est.fit(HeteroData(x_num, x_cat), 0) # or SparseData(sets, mask)
    labels, dists = est.predict(HeteroData(new_num, new_cat))
    model = est.fit(DenseData(x), 0, mesh=make_mesh())   # sharded, per rank
    labels, dists = est.predict(DenseData(new_x), mesh=make_mesh())

Underneath, the paper's three stages are the reference's protocols:
``LSHBucketer`` (QALSH rank partition for dense rows, MinHash (K, L)
buckets over coded items for hetero and sparse rows), ``SILKSeeder`` and
``KernelAssigner``. Randomness is drawn in one place,
``LSHBucketer.split_key``, from a ``torch.Generator``. ``discover`` takes
the drawn arrays as arguments, so a caller can hand it arrays drawn
elsewhere (the parity tests hand it the reference's JAX-drawn ones). The
§4.1 seeders ``KMeansPPSeeder`` and ``ScalableKMeansPPSeeder``
(``needs_buckets=False``) skip the LSH draws and bucketing and draw from
the fit's generator themselves.

``mesh=`` (a ``utils.compat.Mesh`` over a ``torch.distributed`` process
group: NCCL on cards, gloo on CPU processes) shards the fit and predict
over ranks. Every rank calls ``fit`` with the same global data and seed
and gets the same model and global labels: distributed SILK discovery by
default (``core.distributed.discover_sharded``), bit-identical to the
in-core fit, or discovery on an all-gathered reservoir
(``discovery="gathered"``, and ``seed_cap=``).

``chunk=`` is the out-of-core fit (``core.streaming``): discovery on a
reservoir of at most ``seed_cap`` rows, then the assignment pass streamed
over host chunks (arrays, or a ``chunks=`` iterator), with or without
``mesh=``. ``predict(probes=)`` probes the model's center index, and
``predict(batch=)`` serves in batches of that many rows.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, ClassVar

import numpy as np
import torch

from repro_torch.core import assign as assign_mod
from repro_torch.core import baselines as baselines_mod
from repro_torch.core import distributed as dist_mod
from repro_torch.core import lsh
from repro_torch.core.buckets import (BucketTables, partition_by_signature,
                                      partition_even)
from repro_torch.core.geek import (GeekConfig, GeekResult, _seed_codes,
                                   _seed_dense, hetero_code_bits,
                                   make_hetero_transform,
                                   make_sparse_transform)
from repro_torch.core.model import (GeekModel, NumericDiscretizer,
                                    quantile_boundaries)
from repro_torch.core.model import predict as model_predict
from repro_torch.core.silk import Seeds, silk_seeding
from repro_torch.core.transform import HeteroTransform, IdentityTransform
from repro_torch.utils import compat
from repro_torch.utils.device import (as_generator, full_precision_matmul,
                                      parts_to_device, resolve_device)
from repro_torch.utils.hashing import derive_hash_keys


# ---------------------------------------------------------------------------
# Dataset spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseData:
    """Homogeneous dense rows (Euclidean metric, paper Algorithm 1).

    ``x`` is an (n, d) array or tensor; ``chunks``, an iterable of (m_i,
    d) host chunks for the streaming fit (``fit(..., chunk=)``), in place
    of ``x``.
    """

    x: Any = None
    chunks: Any = None
    kind: ClassVar[str] = "dense"

    @property
    def parts(self) -> tuple:
        """In-core part tuple ``(x,)``; a chunk iterator has none."""
        if self.chunks is not None:
            if self.x is not None:
                raise ValueError("pass exactly one of x / chunks")
            raise ValueError("chunk-iterator dataset has no in-core parts; "
                             "fit it with chunk= (streaming)")
        if self.x is None:
            raise ValueError("dense data needs x")
        return (self.x,)

    def payload(self):
        """The raw fit input (array or chunk iterator) for streaming."""
        if (self.x is None) == (self.chunks is None):
            raise ValueError("pass exactly one of x / chunks")
        return self.x if self.x is not None else self.chunks


@dataclasses.dataclass(frozen=True)
class HeteroData:
    """Heterogeneous rows (1 − Jaccard metric, paper Algorithm 2).

    ``x_num`` (n, d_num) floats, quantile-discretized by the fitted
    transform, and/or ``x_cat`` (n, d_cat) integer categories; at least
    one must be present. ``chunks``, an iterable of ``(x_num_i,
    x_cat_i)`` pairs for the streaming fit, in place of the arrays.
    """

    x_num: Any = None
    x_cat: Any = None
    chunks: Any = None
    kind: ClassVar[str] = "hetero"

    @property
    def parts(self) -> tuple:
        """In-core part tuple ``(x_num, x_cat)`` (either may be None)."""
        if self.chunks is not None:
            raise ValueError("chunk-iterator dataset has no in-core parts; "
                             "fit it with chunk= (streaming)")
        if self.x_num is None and self.x_cat is None:
            raise ValueError("hetero data needs x_num and/or x_cat")
        return (self.x_num, self.x_cat)

    def payload(self):
        """The raw fit input (part tuple or chunk iterator) for streaming."""
        if self.chunks is not None:
            if self.x_num is not None or self.x_cat is not None:
                raise ValueError("pass arrays OR chunks, not both")
            return self.chunks
        return self.parts


@dataclasses.dataclass(frozen=True)
class SparseData:
    """Sparse sets (Jaccard metric via DOPH, paper Algorithm 3).

    ``sets`` (n, s_max) integer items, padded; ``mask`` (n, s_max) bool,
    True for real items. ``chunks``, an iterable of ``(sets_i, mask_i)``
    pairs for the streaming fit, in place of the arrays.
    """

    sets: Any = None
    mask: Any = None
    chunks: Any = None
    kind: ClassVar[str] = "sparse"

    @property
    def parts(self) -> tuple:
        """In-core part tuple ``(sets, mask)``."""
        if self.chunks is not None:
            raise ValueError("chunk-iterator dataset has no in-core parts; "
                             "fit it with chunk= (streaming)")
        if self.sets is None or self.mask is None:
            raise ValueError("sparse data needs both sets and mask")
        return (self.sets, self.mask)

    def payload(self):
        """The raw fit input (part tuple or chunk iterator) for streaming."""
        if self.chunks is not None:
            if self.sets is not None or self.mask is not None:
                raise ValueError("pass arrays OR chunks, not both")
            return self.chunks
        return self.parts


Dataset = DenseData | HeteroData | SparseData


def as_dataset(data) -> Dataset:
    """Coerce fit/predict input to a ``Dataset`` spec.

    A bare (n, d) array means dense; hetero and sparse inputs must be
    explicit, since a 2-tuple of arrays could be either.
    """
    if isinstance(data, (DenseData, HeteroData, SparseData)):
        return data
    if hasattr(data, "shape") and len(data.shape) == 2:
        return DenseData(data)
    raise TypeError(
        f"expected DenseData/HeteroData/SparseData or an (n, d) array, got "
        f"{type(data).__name__} — tuples are ambiguous (hetero vs sparse)")


# ---------------------------------------------------------------------------
# Stage protocols
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LSHBucketer:
    """The paper's LSH bucket layer, one scheme per data kind.

    dense  — QALSH projections, even rank partition into t buckets/table
    hetero — quantile-discretize ++ categorical, MinHash (K, L) buckets
    sparse — keyed 16-bit DOPH codes, MinHash (K, L) buckets
    """

    name: ClassVar[str] = "lsh"

    def split_key(self, kind: str, gen: torch.Generator, d: int,
                  cfg: GeekConfig):
        """Draw the fit's randomness: ``(tkeys, bkeys, table_keys)``.

        The counterpart of ``repro``'s ``split_key``, which splits a JAX
        key that each stage derives its arrays from; here the arrays are
        drawn, in one place and in this order:

        - dense: the (d, m) QALSH matrix ``a``; ``bkeys = (a,)``;
        - hetero: the (1, 2) item-hash pair, then the (bucket_l,
          bucket_k, 2) signature keys; ``bkeys = (item, sig)``;
        - sparse: the raw (2,) uint32 DOPH key (``tkeys``, the
          transform's, from which it derives its hash pair as the
          reference does), then the item pair and the signature keys as
          for hetero;

        then, for every kind, the (silk_l + 1, silk_k, 2) SILK table keys
        that the seeder consumes. ``d`` is the dense width (unused for
        the other kinds).
        """
        tkeys = None
        if kind == "dense":
            bkeys = (lsh.qalsh_projections(gen, d, cfg.m),)
        else:
            if kind == "sparse":
                tkeys = torch.randint(0, 1 << 32, (2,), generator=gen,
                                      device=gen.device, dtype=torch.int64)
            bkeys = (derive_hash_keys(gen, (1,)),
                     derive_hash_keys(gen, (cfg.bucket_l, cfg.bucket_k)))
        table_keys = derive_hash_keys(gen, (cfg.silk_l + 1, cfg.silk_k))
        return tkeys, bkeys, table_keys

    def fit_transform(self, kind: str, parts: tuple, tkeys,
                      cfg: GeekConfig, *, boundaries=None):
        """Fit the persistent raw→space transform for one kind.

        ``boundaries`` replaces the hetero quantile fit (the streaming
        fit's ``boundaries="exact"``, from every row)."""
        if kind == "dense":
            return IdentityTransform()
        if kind == "hetero":
            x_num = parts[0]
            if (boundaries is not None and x_num is not None
                    and x_num.shape[1] > 0):
                return HeteroTransform(NumericDiscretizer(boundaries))
            return make_hetero_transform(x_num, cfg.t_cat)
        return make_sparse_transform(tkeys, cfg)

    def buckets(self, kind: str, space: torch.Tensor, bkeys: tuple,
                cfg: GeekConfig) -> BucketTables:
        """Bucket the space with the kind's LSH family."""
        if kind == "dense":
            (a,) = bkeys
            return partition_even(lsh.qalsh_hash(space, a.to(space.dtype)),
                                  cfg.t)
        item_keys, sig_keys = bkeys
        items = lsh.code_items(space, item_keys)
        # every item is real: the reference's all-True mask changes nothing
        return partition_by_signature(lsh.minhash_signatures(items, None,
                                                             sig_keys))

    def metric(self, kind: str) -> str:
        """Assignment metric for one data kind ("l2" or "hamming")."""
        return "l2" if kind == "dense" else "hamming"

    def code_bits(self, kind: str, parts: tuple, cfg: GeekConfig) -> int:
        """Static code-width bound feeding the packed/one-hot dispatch."""
        if kind == "dense":
            return 0
        if kind == "hetero":
            return hetero_code_bits(cfg, parts[1])
        return 16  # DOPH codes are truncated to 16 bits


@dataclasses.dataclass(frozen=True)
class SILKSeeder:
    """The paper's SILK seeding — k* discovered from similar buckets.

    ``needs_buckets=True``: the facade builds the bucketer's LSH tables
    and hands them over; the seeder never touches raw data.
    """

    name: ClassVar[str] = "silk"
    needs_buckets: ClassVar[bool] = True

    def seed(self, space: torch.Tensor, buckets: BucketTables,
             table_keys: torch.Tensor, cfg: GeekConfig
             ) -> tuple[Seeds, torch.Tensor]:
        """Run L SILK rounds + dedup over the bucket tables."""
        del space
        return silk_seeding(buckets, table_keys, silk_k=cfg.silk_k,
                            silk_l=cfg.silk_l, delta=cfg.delta,
                            pair_cap=cfg.pair_cap, k_max=cfg.k_max)


def _index_seeds(idx: torch.Tensor, k: int, k_max: int) -> Seeds:
    """Wrap k seed-point row indices in the ``Seeds`` contract.

    Singleton groups: group j holds exactly data row ``idx[j]``, so the
    centroid centers are the seed rows bit for bit (a one-row segment
    mean is the row itself).
    """
    if k > k_max:
        raise ValueError(f"seeder k={k} exceeds GeekConfig.k_max={k_max}")
    dev = idx.device
    return Seeds(group=torch.arange(k, dtype=torch.int32, device=dev),
                 id=idx.to(torch.int32),
                 valid=torch.ones((k,), dtype=torch.bool, device=dev),
                 k_star=torch.tensor(k, dtype=torch.int32, device=dev),
                 k_max=k_max)


@dataclasses.dataclass(frozen=True)
class KMeansPPSeeder:
    """k-means++ D² seeding behind the Seeds contract (k pre-specified).

    ``needs_buckets=False``: the facade skips LSH bucketing, draws nothing
    itself and hands the seeder the whole fit generator, so
    ``GEEK(cfg, seeder=KMeansPPSeeder(k)).fit(DenseData(x), seed)``
    assigns exactly like ``baselines.seed_then_assign(x, k, seed)``, bit
    for bit on one device. L2 spaces only: D² sampling has no meaning
    over categorical codes.
    """

    k: int
    name: ClassVar[str] = "kmeans++"
    needs_buckets: ClassVar[bool] = False
    metrics: ClassVar[tuple[str, ...]] = ("l2",)

    def seed(self, space: torch.Tensor, buckets, gen: torch.Generator,
             cfg: GeekConfig) -> tuple[Seeds, torch.Tensor]:
        """Draw k D²-sampled seed rows as singleton seed groups."""
        del buckets
        idx = baselines_mod.kmeanspp_indices(space, self.k, gen)
        return _index_seeds(idx, self.k, cfg.k_max), torch.zeros(
            (), dtype=torch.int32, device=space.device)


@dataclasses.dataclass(frozen=True)
class ScalableKMeansPPSeeder:
    """k-means‖ (Bahmani et al. '12) behind the Seeds contract.

    Oversample, then reduce: ``rounds`` rounds of ``oversample``
    D²-proportional draws, candidates weighted by attraction, reduced to
    k by weighted k-means++ (``baselines.scalable_kmeanspp_indices``).
    """

    k: int
    rounds: int = 5
    oversample: int | None = None
    name: ClassVar[str] = "scalable-kmeans++"
    needs_buckets: ClassVar[bool] = False
    metrics: ClassVar[tuple[str, ...]] = ("l2",)

    def seed(self, space: torch.Tensor, buckets, gen: torch.Generator,
             cfg: GeekConfig) -> tuple[Seeds, torch.Tensor]:
        """Oversample + reduce to k singleton seed groups."""
        del buckets
        idx = baselines_mod.scalable_kmeanspp_indices(
            space, self.k, gen, rounds=self.rounds,
            oversample=self.oversample, block=cfg.assign_block)
        return _index_seeds(idx, self.k, cfg.k_max), torch.zeros(
            (), dtype=torch.int32, device=space.device)


@dataclasses.dataclass(frozen=True)
class KernelAssigner:
    """Central vectors (centroids for l2, per-attribute modes for
    hamming) + the one-pass assignment that fit and predict share."""

    name: ClassVar[str] = "kernel"

    def build(self, space: torch.Tensor, seeds: Seeds, cfg: GeekConfig, *,
              metric: str, bits: int, transform, bucketer_id: str = "",
              seeder_id: str = "") -> GeekModel:
        """Centers + model for one fit — everything but the n-sized pass."""
        if metric == "l2":
            _, _, model = _seed_dense(space, seeds, cfg, transform=transform,
                                      bucketer_id=bucketer_id,
                                      seeder_id=seeder_id)
            return model
        return _seed_codes(space, seeds, cfg, bits=bits, transform=transform,
                           bucketer_id=bucketer_id, seeder_id=seeder_id)

    def assign(self, model: GeekModel, space: torch.Tensor):
        """One-pass assignment: ``model.predict``'s code path."""
        return model_predict(model, space)


# ---------------------------------------------------------------------------
# Discovery + the in-core fit body
# ---------------------------------------------------------------------------

def discover(kind: str, parts: tuple, cfg: GeekConfig, bucketer, seeder, *,
             tkeys, bkeys: tuple, skeys: torch.Tensor, code=None,
             boundaries=None):
    """Stage 1 + 2: fit the transform, bucket, seed.

    ``tkeys`` / ``bkeys`` / ``skeys`` are the drawn arrays
    (``LSHBucketer.split_key``); for a seeder with ``needs_buckets=False``
    they are ``(None, None, generator)``: no bucket tables are built and
    the seeder draws from the fit's generator itself. ``code`` optionally
    replaces the default ``transform(*parts)`` with ``code(transform,
    parts)`` (the gathered sparse fit codes each rank's rows and gathers
    the narrow codes, not the raw sets). ``boundaries`` goes to the
    bucketer's ``fit_transform``. Returns ``(transform, space, seeds,
    overflow)``.
    """
    transform = bucketer.fit_transform(kind, parts, tkeys, cfg,
                                       boundaries=boundaries)
    space = transform(*parts) if code is None else code(transform, parts)
    buckets = (bucketer.buckets(kind, space, bkeys, cfg)
               if bkeys is not None else None)
    seeds, overflow = seeder.seed(space, buckets, skeys, cfg)
    return transform, space, seeds, overflow


def _fit_incore(parts: tuple, keys: tuple, *, cfg: GeekConfig, kind: str,
                bucketer, seeder, assigner) -> tuple[GeekResult, GeekModel]:
    """In-core fit: discover + build + ONE assignment pass. ``keys`` is
    ``split_key``'s (tkeys, bkeys, skeys)."""
    tkeys, bkeys, skeys = keys
    transform, space, seeds, overflow = discover(kind, parts, cfg, bucketer,
                                                 seeder, tkeys=tkeys,
                                                 bkeys=bkeys, skeys=skeys)
    model = assigner.build(space, seeds, cfg, metric=bucketer.metric(kind),
                           bits=bucketer.code_bits(kind, parts, cfg),
                           transform=transform, bucketer_id=bucketer.name,
                           seeder_id=seeder.name)
    labels, dists = assigner.assign(model, space)
    radius = assign_mod.cluster_radius(dists, labels, cfg.k_max)
    result = GeekResult(labels, dists, model.centers, model.center_valid,
                        seeds.k_star, radius, seeds, overflow)
    return result, dataclasses.replace(model, radius=radius)


def _seed_reservoir(parts: tuple, keys: tuple, boundaries, *,
                    cfg: GeekConfig, kind: str, bucketer, seeder, assigner):
    """Discovery on a streaming reservoir: the in-core pipeline minus the
    n-sized pass (``core.streaming`` streams it). Returns ``(model,
    seeds, overflow)``; the reservoir's coded space is freed on return."""
    tkeys, bkeys, skeys = keys
    transform, space, seeds, overflow = discover(
        kind, parts, cfg, bucketer, seeder, tkeys=tkeys, bkeys=bkeys,
        skeys=skeys, boundaries=boundaries)
    model = assigner.build(space, seeds, cfg, metric=bucketer.metric(kind),
                           bits=bucketer.code_bits(kind, parts, cfg),
                           transform=transform, bucketer_id=bucketer.name,
                           seeder_id=seeder.name)
    return model, seeds, overflow


# ---------------------------------------------------------------------------
# Sharded fit: distributed discovery by default, gathered as the fallback
# ---------------------------------------------------------------------------

def _resolve_discovery(discovery: str | None, seed_cap, n: int, bucketer,
                       seeder) -> str:
    """Resolve the ``discovery=`` knob to "sharded" or "gathered".

    ``None`` (the default) means auto: distributed SILK discovery
    (``core.distributed.discover_sharded``) when the stock
    ``LSHBucketer`` + ``SILKSeeder`` pipeline runs at full coverage,
    else "gathered", with a ``UserWarning`` naming every reason, since the
    gathered plan replicates the reservoir on every rank. An explicit
    ``"sharded"`` raises in those cases instead; an explicit
    ``"gathered"`` always gathers, silently.
    """
    if discovery not in (None, "sharded", "gathered"):
        raise ValueError(f"discovery must be None (auto), 'sharded' or "
                         f"'gathered', got {discovery!r}")
    if discovery == "gathered":
        return "gathered"
    reasons = []
    if seed_cap is not None and seed_cap < n:
        reasons.append(f"seed_cap={seed_cap} subsamples the reservoir "
                       f"(n={n})")
    if type(bucketer) is not LSHBucketer:
        bname = getattr(bucketer, "name", type(bucketer).__name__)
        reasons.append(f"custom bucketer {bname!r} is not distributable")
    if type(seeder) is not SILKSeeder:
        sname = getattr(seeder, "name", type(seeder).__name__)
        reasons.append(f"seeder {sname!r} does not consume distributed "
                       "bucket tables")
    if not reasons:
        return "sharded"
    if discovery == "sharded":
        raise ValueError(
            "discovery='sharded' was requested explicitly but distributed "
            "discovery cannot run: " + "; ".join(reasons) + ". Pass "
            "discovery='gathered' (replicated-reservoir discovery) or "
            "leave discovery=None to let the fit fall back automatically")
    warnings.warn(
        "discovery=None fell back to gathered (replicated-reservoir) "
        "discovery: " + "; ".join(reasons) + ". Pass "
        "discovery='gathered' explicitly to acknowledge the replication "
        "and silence this warning", UserWarning, stacklevel=4)
    return "gathered"


def _check_gather_bytes(kind: str, parts: tuple, n: int,
                        cfg: GeekConfig) -> None:
    """Fail fast when the gathered reservoir would be unreasonably big:
    with ``seed_cap=None`` every rank holds all of it. Sparse data
    gathers the (n, doph_m) int32 codes, not the raw sets."""
    if kind == "sparse":
        est = n * cfg.doph_m * 4
    else:
        est = sum(n * math.prod(p.shape[1:]) * p.element_size()
                  for p in parts if p is not None)
    if est > cfg.gather_cap_bytes:
        raise ValueError(
            f"gathered discovery would replicate a ~{est:,}-byte "
            f"reservoir per device (cap: GeekConfig.gather_cap_bytes="
            f"{cfg.gather_cap_bytes:,}); use discovery='sharded' "
            "(distributed discovery, the default for the stock "
            "pipeline), pass seed_cap= to subsample the reservoir, or "
            "raise gather_cap_bytes")


def _fit_sharded_sharded(local_parts: tuple, keys: tuple, mesh, n: int, *,
                         cfg: GeekConfig, kind: str, bucketer, seeder,
                         assigner):
    """Per-rank fit body with distributed discovery: seeds, centers,
    labels and radius bit-identical to the in-core fit."""
    transform, space_local, seeds, overflow = dist_mod.discover_sharded(
        kind, local_parts, keys, cfg, mesh, n)
    # rebuild the seed-member rows on every rank (one-owner sum) and replay
    # the in-core center math on them: the same rows in the same order
    space_sel = dist_mod.collect_seed_rows(space_local, seeds.id,
                                           seeds.valid, mesh)
    local_seeds = seeds._replace(id=torch.arange(
        space_sel.shape[0], dtype=torch.int32, device=space_sel.device))
    model = assigner.build(space_sel, local_seeds, cfg,
                           metric=bucketer.metric(kind),
                           bits=bucketer.code_bits(kind, local_parts, cfg),
                           transform=transform, bucketer_id=bucketer.name,
                           seeder_id=seeder.name)
    return model, space_local, seeds, overflow


def _fit_sharded_gathered(local_parts: tuple, keys: tuple, mesh, n: int, *,
                          stride: int, cfg: GeekConfig, kind: str, bucketer,
                          seeder, assigner):
    """Per-rank fit body with discovery on the all-gathered (strided)
    reservoir: ``stride == 1`` gathers the dataset in row order, hence
    bit-identity with the in-core fit for any pipeline."""
    nl = local_parts[0 if local_parts[0] is not None else 1].shape[0]
    s = -(-nl // stride)                 # reservoir rows per rank
    keep = n if stride == 1 else None    # exact cut only at stride 1
    local_codes = []                     # the sparse hook codes once
    if kind == "sparse":
        def code(t, p):
            """Code this rank's rows, gather the strided reservoir."""
            local_codes.append(t(*p))
            return dist_mod._gather_rows(local_codes[0][::stride].contiguous(),
                                         mesh, keep)
        disc_parts = local_parts
    else:
        code = None
        disc_parts = tuple(
            None if p is None else dist_mod._gather_rows(
                p[::stride].contiguous(), mesh, keep) for p in local_parts)
    tkeys, bkeys, skeys = keys
    transform, space_res, seeds, overflow = discover(
        kind, disc_parts, cfg, bucketer, seeder, tkeys=tkeys, bkeys=bkeys,
        skeys=skeys, code=code)
    space_local = local_codes[0] if local_codes else transform(*local_parts)
    model = assigner.build(space_res, seeds, cfg,
                           metric=bucketer.metric(kind),
                           bits=bucketer.code_bits(kind, local_parts, cfg),
                           transform=transform, bucketer_id=bucketer.name,
                           seeder_id=seeder.name)
    if stride > 1:                       # reservoir row ids -> dataset ids
        gid = ((seeds.id // s) * nl + (seeds.id % s) * stride) % n
        seeds = seeds._replace(id=torch.where(seeds.valid, gid, seeds.id))
    return model, space_local, seeds, overflow


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

class GEEK:
    """The GEEK estimator for dense, hetero and sparse data, in-core or
    sharded over a process group (``mesh=``).

    Parameters
    ----------
    cfg : GeekConfig
        Static pipeline configuration.
    bucketer, seeder, assigner
        Stage strategies (defaults ``LSHBucketer``, ``SILKSeeder``,
        ``KernelAssigner``).
    device : str or torch.device or None
        ``None`` runs on ``cuda`` and raises when there is no card;
        ``"cpu"`` runs the plain PyTorch path.

    Attributes
    ----------
    model_ : GeekModel
        The fitted model after ``fit``.
    result_ : GeekResult
        The per-run result (labels/dists/seeds on the fit data).
    """

    def __init__(self, cfg: GeekConfig, *, bucketer=None, seeder=None,
                 assigner=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bucketer = LSHBucketer() if bucketer is None else bucketer
        self.seeder = SILKSeeder() if seeder is None else seeder
        self.assigner = KernelAssigner() if assigner is None else assigner
        self.model_: GeekModel | None = None
        self.result_: GeekResult | None = None
        self.stream_peak_bytes_: int | None = None

    def _draws(self, kind: str, seed, d: int) -> tuple:
        """The fit's randomness: ``split_key``'s arrays, or, for a seeder
        with ``needs_buckets=False``, no LSH draw at all and the whole
        generator for the seeder (what makes ``KMeansPPSeeder`` reproduce
        ``baselines.seed_then_assign``)."""
        gen = as_generator(seed, self.device)
        if not getattr(self.seeder, "needs_buckets", True):
            return None, None, gen
        return self.bucketer.split_key(kind, gen, d, self.cfg)

    def _check_pipeline(self, kind: str) -> None:
        """Reject seeders that cannot run in this kind's metric space."""
        metric = self.bucketer.metric(kind)
        allowed = getattr(self.seeder, "metrics", None)
        if allowed is not None and metric not in allowed:
            raise ValueError(
                f"seeder {self.seeder.name!r} supports metrics {allowed}, "
                f"but {kind!r} data assigns in {metric!r}")

    def fit(self, data, seed, *, mesh=None, mesh_axis: str = "data",
            chunk: int | None = None, seed_cap: int | None = None,
            boundaries: str = "reservoir",
            discovery: str | None = None) -> GeekModel:
        """Fit the pipeline on one dataset.

        Parameters
        ----------
        data : DenseData, HeteroData, SparseData or (n, d) array / tensor
            Moved to the estimator's device: dense rows and numeric
            columns as float32, categories and set items as int32,
            masks as bool. With ``mesh=`` every rank passes the same
            global data and fits its own rows.
        seed : int or torch.Generator
            Source of the fit's randomness (a generator on the
            estimator's device type). The sharded fit draws exactly as
            the in-core fit does, so one seed gives one model.
        mesh : utils.compat.Mesh or None
            Shard the fit over the ranks of a process group (NCCL for a
            ``cuda`` estimator, gloo for ``cpu``); call on every rank.
        mesh_axis : str
            The mesh's axis name (checked).
        chunk : int or None
            Stream the assignment pass over host chunks of this many
            rows (``core.streaming``): the pass's device memory is
            bounded by the chunk, not by n. ``data`` may then be a
            chunk iterator (``DenseData(chunks=...)``). With ``mesh=``
            each chunk is split over the ranks (``chunk`` a multiple of
            the ranks). The result's labels and dists are host tensors,
            and ``stream_peak_bytes_`` holds the pass's device memory
            on the card: its peak above what was allocated when it began
            (None on the CPU).
        seed_cap : int or None
            Streaming or sharded fits: at most this many reservoir rows
            for discovery (``None`` keeps all of them: the in-core fit's
            seeds, centers and labels, bit for bit).
        boundaries : {"reservoir", "exact"}
            Hetero streaming fits only: quantile boundaries from the
            reservoir, or from every row (a second host pass over the
            numeric columns).
        discovery : {None, "sharded", "gathered"}
            Sharded fits without ``chunk`` only, as in the reference:
            ``None`` (auto)
            distributes SILK discovery, bit-identical to the in-core fit,
            and falls back to "gathered" with a ``UserWarning`` naming
            the reasons when ``seed_cap`` subsamples or a custom
            bucketer or seeder is plugged in; an explicit ``"sharded"``
            raises then instead; ``"gathered"`` runs discovery on the
            all-gathered reservoir.

        Returns
        -------
        GeekModel
            The fitted model (also ``model_``; the per-run
            ``GeekResult`` lands in ``result_``, its labels and dists
            global (n,) on every rank).
        """
        data = as_dataset(data)
        self._check_pipeline(data.kind)
        if boundaries not in ("reservoir", "exact"):
            raise ValueError(f"boundaries must be 'reservoir' or 'exact', "
                             f"got {boundaries!r}")
        if boundaries == "exact" and not (chunk is not None
                                          and data.kind == "hetero"):
            raise ValueError(
                "boundaries='exact' only applies to hetero streaming fits "
                "(chunk=...); in-core and sharded fits with seed_cap=None "
                "use exact boundaries already")
        full_precision_matmul()
        if chunk is not None:
            result, model = self._fit_streaming(data, seed, chunk, seed_cap,
                                                boundaries, mesh, mesh_axis)
            self.result_, self.model_ = result, model
            return model
        parts = parts_to_device(data.parts, self.device)
        if data.kind == "dense":
            parts = (parts[0].to(torch.float32),)
        if mesh is not None:
            result, model = self._fit_sharded(data.kind, parts, seed, mesh,
                                              mesh_axis, seed_cap, discovery)
        else:
            if seed_cap is not None:
                raise ValueError("seed_cap needs a bounded-memory mode: "
                                 "pass chunk= (streaming) or mesh= (sharded)")
            d = next(p for p in parts if p is not None).shape[1]
            keys = self._draws(data.kind, seed, d)
            result, model = _fit_incore(parts, keys, cfg=self.cfg,
                                        kind=data.kind,
                                        bucketer=self.bucketer,
                                        seeder=self.seeder,
                                        assigner=self.assigner)
        self.result_, self.model_ = result, model
        return model

    def _fit_streaming(self, data, seed, chunk, seed_cap, boundaries, mesh,
                       mesh_axis):
        """Out-of-core fit: reservoir discovery + the streamed pass."""
        from repro_torch.core import streaming as stream_mod
        cfg, kind = self.cfg, data.kind
        if mesh is not None:
            compat.check_device(mesh, self.device, mesh_axis)
        stream_mod._check_mesh_chunk(mesh, chunk)
        nparts = 1 if kind == "dense" else 2
        chunks, n, whole = stream_mod._collect(data.payload(), nparts, chunk)
        if kind == "sparse" and (chunks[0][0] is None or chunks[0][1] is None):
            raise ValueError("sparse streaming needs both sets and mask")
        sample, sample_idx = stream_mod._stride_sample(chunks, n, seed_cap,
                                                       whole)
        bounds = None
        if boundaries == "exact" and chunks[0][0] is not None:
            # every row's numeric columns, sorted on the host: the values
            # NumericDiscretizer.fit would pick on the device
            num = (whole[0] if whole is not None
                   else np.concatenate([c[0] for c in chunks], axis=0))
            num = torch.from_numpy(np.ascontiguousarray(num, np.float32))
            bounds = quantile_boundaries(torch.sort(num, dim=0).values,
                                         cfg.t_cat).to(self.device)
        present = parts_to_device(sample, self.device)
        d = next(p for p in present if p is not None).shape[1]
        keys = self._draws(kind, seed, d)
        model, seeds, overflow = _seed_reservoir(
            present, keys, bounds, cfg=cfg, kind=kind,
            bucketer=self.bucketer, seeder=self.seeder,
            assigner=self.assigner)
        del present, sample     # the reservoir's device copy goes here
        result, model, self.stream_peak_bytes_ = stream_mod._streamed_fit(
            chunks, n, cfg, chunk, model, seeds, overflow, sample_idx,
            assigner=self.assigner, mesh=mesh)
        return result, model

    def _fit_sharded(self, kind, parts, seed, mesh, mesh_axis, seed_cap,
                     discovery):
        """Sharded fit: each rank takes its rows, discovery per knob."""
        cfg = self.cfg
        compat.check_device(mesh, self.device, mesh_axis)
        none_pattern = tuple(p is None for p in parts)
        if kind != "hetero" and any(none_pattern):
            raise ValueError(f"{kind} fit parts must not be None")
        local, n = dist_mod._pad_and_shard(
            [p for p in parts if p is not None], mesh)
        local_parts = dist_mod._reinsert_none(local, none_pattern)
        mode = _resolve_discovery(discovery, seed_cap, n, self.bucketer,
                                  self.seeder)
        stride = (1 if seed_cap is None or seed_cap >= n
                  else -(-n // seed_cap))
        if mode == "gathered" and stride == 1:
            _check_gather_bytes(kind, parts, n, cfg)
        d = next(p for p in parts if p is not None).shape[1]
        keys = self._draws(kind, seed, d)
        common = dict(cfg=cfg, kind=kind, bucketer=self.bucketer,
                      seeder=self.seeder, assigner=self.assigner)
        if mode == "sharded":
            model, space_local, seeds, overflow = _fit_sharded_sharded(
                local_parts, keys, mesh, n, **common)
        else:
            model, space_local, seeds, overflow = _fit_sharded_gathered(
                local_parts, keys, mesh, n, stride=stride, **common)
        labels, dists = self.assigner.assign(model, space_local)
        radius = compat.pmax(assign_mod.cluster_radius(dists, labels,
                                                       cfg.k_max), mesh)
        model = dataclasses.replace(model, radius=radius)
        result = GeekResult(dist_mod._gather_rows(labels, mesh, n),
                            dist_mod._gather_rows(dists, mesh, n),
                            model.centers, model.center_valid, model.k_star,
                            radius, seeds, overflow)
        return result, model

    def predict(self, data, *, model: GeekModel | None = None, mesh=None,
                mesh_axis: str = "data", batch: int | None = None,
                probes: int | None = None):
        """Assign new raw rows with the fitted (or given) model: the
        parts are coded by the persisted fit-time transform
        (``model.encode``) on the model's device. With ``mesh=`` (call
        on every rank, same global rows) each rank assigns its rows and
        every rank gets the global labels
        (``core.distributed.make_predict_sharded``), bit-identical to
        the unsharded predict. ``probes=p`` probes the model's center
        index, empty-probe rows patched by the exact scan
        (``core.model.predict``). ``batch=`` serves that many rows at a
        time (``_predict_batched``); it composes with ``mesh=`` and
        ``probes=`` and gives the unbatched call's labels."""
        if model is None:
            model = self.model_
        if model is None:
            raise ValueError("not fitted: call fit() first or pass model=")
        parts = as_dataset(data).parts
        if batch is not None:
            return self._predict_batched(model, parts, batch, mesh,
                                         mesh_axis, probes)
        if mesh is not None:
            return dist_mod.make_predict_sharded(
                mesh, axis=mesh_axis, probes=probes)(model, *parts)
        full_precision_matmul()
        parts = parts_to_device(parts, model.device)
        return model_predict(model, model.encode(*parts), probes=probes)

    def _predict_batched(self, model, parts, batch, mesh, mesh_axis, probes):
        """Serve ``batch`` rows at a time: host slices, the ragged tail
        padded with sentinel rows (``streaming._pad_rows``) so every step
        has one shape; rows are independent, so the labels are the
        unbatched call's. Returns host tensors."""
        from repro_torch.core.streaming import _host, _pad_rows
        if batch < 1:
            raise ValueError(f"batch must be positive, got {batch}")
        host = tuple(None if p is None else _host(p) for p in parts)
        n = next(p.shape[0] for p in host if p is not None)
        labels = torch.empty((n,), dtype=torch.int32)
        dists = torch.empty((n,), dtype=torch.float32)
        for off in range(0, n, batch):
            m = min(batch, n - off)
            sl = tuple(None if p is None else p[off:off + m] for p in host)
            if m < batch:
                sl = tuple(None if p is None else _pad_rows(p, batch)
                           for p in sl)
            lab, dst = self.predict(self._wrap_parts(model, sl), model=model,
                                    mesh=mesh, mesh_axis=mesh_axis,
                                    probes=probes)
            labels[off:off + m] = lab[:m].cpu()
            dists[off:off + m] = dst[:m].cpu()
        return labels, dists

    @staticmethod
    def _wrap_parts(model, parts: tuple) -> Dataset:
        """Rewrap raw part slices in the model's Dataset kind."""
        kind = getattr(model.transform, "kind", "identity")
        if kind == "hetero":
            return HeteroData(*parts)
        if kind == "sparse":
            return SparseData(*parts)
        return DenseData(*parts)
