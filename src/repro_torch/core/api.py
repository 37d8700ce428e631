"""One estimator facade + pluggable stage protocols, for in-core data.

The counterpart of ``repro.core.api``::

    from repro_torch import GEEK, DenseData, HeteroData, SparseData, predict

    est = GEEK(GeekConfig(k_max=256))            # runs on cuda
    model = est.fit(DenseData(x), 0)             # seed or torch.Generator
    model = est.fit(HeteroData(x_num, x_cat), 0) # or SparseData(sets, mask)
    labels, dists = est.predict(HeteroData(new_num, new_cat))

Underneath, the paper's three stages are the reference's protocols:
``LSHBucketer`` (QALSH rank partition for dense rows, MinHash (K, L)
buckets over coded items for hetero and sparse rows), ``SILKSeeder`` and
``KernelAssigner``. Randomness is drawn in one place,
``LSHBucketer.split_key``, from a ``torch.Generator``. ``discover`` takes
the drawn arrays as arguments, so a caller can hand it arrays drawn
elsewhere (the parity tests hand it the reference's JAX-drawn ones).

Not ported yet, and refused with ``NotImplementedError``: ``mesh=``
(ROADMAP.md Queue 1 item 12), ``chunk=`` / ``seed_cap=`` and chunk
iterators (item 11), ``batch=`` (item 13) and ``probes=`` (item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch

from repro_torch.core import assign as assign_mod
from repro_torch.core import lsh
from repro_torch.core.buckets import (BucketTables, partition_by_signature,
                                      partition_even)
from repro_torch.core.geek import (GeekConfig, GeekResult, _seed_codes,
                                   _seed_dense, hetero_code_bits,
                                   make_hetero_transform,
                                   make_sparse_transform)
from repro_torch.core.model import GeekModel
from repro_torch.core.model import predict as model_predict
from repro_torch.core.silk import Seeds, silk_seeding
from repro_torch.core.transform import IdentityTransform
from repro_torch.utils.device import full_precision_matmul, resolve_device
from repro_torch.utils.hashing import derive_hash_keys


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet "
                               f"(ROADMAP.md, Queue 1 item {item})")


# ---------------------------------------------------------------------------
# Dataset spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseData:
    """Homogeneous dense rows (Euclidean metric, paper Algorithm 1).

    ``x`` is an (n, d) array or tensor; ``chunks`` (streaming) is not
    ported yet.
    """

    x: Any = None
    chunks: Any = None
    kind: ClassVar[str] = "dense"

    @property
    def parts(self) -> tuple:
        """In-core part tuple ``(x,)``."""
        if self.chunks is not None:
            raise _not_ported("a chunk-iterator dataset (streaming fit)", 11)
        if self.x is None:
            raise ValueError("dense data needs x")
        return (self.x,)


@dataclasses.dataclass(frozen=True)
class HeteroData:
    """Heterogeneous rows (1 − Jaccard metric, paper Algorithm 2).

    ``x_num`` (n, d_num) floats, quantile-discretized by the fitted
    transform, and/or ``x_cat`` (n, d_cat) integer categories; at least
    one must be present. ``chunks`` (streaming) is not ported yet.
    """

    x_num: Any = None
    x_cat: Any = None
    chunks: Any = None
    kind: ClassVar[str] = "hetero"

    @property
    def parts(self) -> tuple:
        """In-core part tuple ``(x_num, x_cat)`` (either may be None)."""
        if self.chunks is not None:
            raise _not_ported("a chunk-iterator dataset (streaming fit)", 11)
        if self.x_num is None and self.x_cat is None:
            raise ValueError("hetero data needs x_num and/or x_cat")
        return (self.x_num, self.x_cat)


@dataclasses.dataclass(frozen=True)
class SparseData:
    """Sparse sets (Jaccard metric via DOPH, paper Algorithm 3).

    ``sets`` (n, s_max) integer items, padded; ``mask`` (n, s_max) bool,
    True for real items. ``chunks`` (streaming) is not ported yet.
    """

    sets: Any = None
    mask: Any = None
    chunks: Any = None
    kind: ClassVar[str] = "sparse"

    @property
    def parts(self) -> tuple:
        """In-core part tuple ``(sets, mask)``."""
        if self.chunks is not None:
            raise _not_ported("a chunk-iterator dataset (streaming fit)", 11)
        if self.sets is None or self.mask is None:
            raise ValueError("sparse data needs both sets and mask")
        return (self.sets, self.mask)


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


def _to_device(parts: tuple, device) -> tuple:
    """Move raw parts to ``device`` with the types JAX would give them
    (64-bit off): floats as float32, integers as int32, bool masks as
    bool; ``None`` parts stay ``None``."""
    out = []
    for p in parts:
        if p is not None:
            p = torch.as_tensor(p, device=device)
            if p.dtype.is_floating_point:
                p = p.to(torch.float32)
            elif p.dtype != torch.bool:
                p = p.to(torch.int32)
        out.append(p)
    return tuple(out)


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
        - sparse: the (1, 2) DOPH hash pair (``tkeys``, the transform's),
          then the item pair and the signature keys as for hetero;

        then, for every kind, the (silk_l + 1, silk_k, 2) SILK table keys
        that the seeder consumes. ``d`` is the dense width (unused for
        the other kinds).
        """
        tkeys = None
        if kind == "dense":
            bkeys = (lsh.qalsh_projections(gen, d, cfg.m),)
        else:
            if kind == "sparse":
                tkeys = derive_hash_keys(gen, (1,))
            bkeys = (derive_hash_keys(gen, (1,)),
                     derive_hash_keys(gen, (cfg.bucket_l, cfg.bucket_k)))
        table_keys = derive_hash_keys(gen, (cfg.silk_l + 1, cfg.silk_k))
        return tkeys, bkeys, table_keys

    def fit_transform(self, kind: str, parts: tuple, tkeys,
                      cfg: GeekConfig):
        """Fit the persistent raw→space transform for one kind."""
        if kind == "dense":
            return IdentityTransform()
        if kind == "hetero":
            return make_hetero_transform(parts[0], cfg.t_cat)
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
    """The paper's SILK seeding — k* discovered from similar buckets."""

    name: ClassVar[str] = "silk"

    def seed(self, space: torch.Tensor, buckets: BucketTables,
             table_keys: torch.Tensor, cfg: GeekConfig
             ) -> tuple[Seeds, torch.Tensor]:
        """Run L SILK rounds + dedup over the bucket tables."""
        del space
        return silk_seeding(buckets, table_keys, silk_k=cfg.silk_k,
                            silk_l=cfg.silk_l, delta=cfg.delta,
                            pair_cap=cfg.pair_cap, k_max=cfg.k_max)


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
             tkeys, bkeys: tuple, skeys: torch.Tensor):
    """Stage 1 + 2: fit the transform, bucket, seed.

    ``tkeys`` / ``bkeys`` / ``skeys`` are the drawn arrays
    (``LSHBucketer.split_key``). Returns ``(transform, space, seeds,
    overflow)``.
    """
    transform = bucketer.fit_transform(kind, parts, tkeys, cfg)
    space = transform(*parts)
    buckets = bucketer.buckets(kind, space, bkeys, cfg)
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


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

class GEEK:
    """The GEEK estimator for in-core dense, hetero and sparse data.

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

    def _generator(self, seed) -> torch.Generator:
        if isinstance(seed, torch.Generator):
            if seed.device.type != self.device.type:
                raise ValueError(f"generator on {seed.device}, estimator on "
                                 f"{self.device}")
            return seed
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def fit(self, data, seed, *, mesh=None, chunk: int | None = None,
            seed_cap: int | None = None) -> GeekModel:
        """Fit the pipeline on one in-core dataset.

        Parameters
        ----------
        data : DenseData, HeteroData, SparseData or (n, d) array / tensor
            Moved to the estimator's device: dense rows and numeric
            columns as float32, categories and set items as int32,
            masks as bool.
        seed : int or torch.Generator
            Source of the fit's randomness (a generator on the
            estimator's device type).

        Returns
        -------
        GeekModel
            The fitted model (also ``model_``; the per-run
            ``GeekResult`` lands in ``result_``).
        """
        if mesh is not None:
            raise _not_ported("the sharded fit (mesh=)", 12)
        if chunk is not None or seed_cap is not None:
            raise _not_ported("the streaming fit (chunk=, seed_cap=)", 11)
        data = as_dataset(data)
        full_precision_matmul()
        parts = _to_device(data.parts, self.device)
        if data.kind == "dense":
            parts = (parts[0].to(torch.float32),)
        d = next(p for p in parts if p is not None).shape[1]
        keys = self.bucketer.split_key(data.kind, self._generator(seed), d,
                                       self.cfg)
        result, model = _fit_incore(parts, keys, cfg=self.cfg,
                                    kind=data.kind, bucketer=self.bucketer,
                                    seeder=self.seeder,
                                    assigner=self.assigner)
        self.result_, self.model_ = result, model
        return model

    def predict(self, data, *, model: GeekModel | None = None, mesh=None,
                batch: int | None = None, probes: int | None = None):
        """Assign new raw rows with the fitted (or given) model: the
        parts are coded by the persisted fit-time transform
        (``model.encode``) on the model's device."""
        if mesh is not None:
            raise _not_ported("sharded serving (mesh=)", 12)
        if batch is not None:
            raise _not_ported("partial-batch serving (batch=)", 13)
        if model is None:
            model = self.model_
        if model is None:
            raise ValueError("not fitted: call fit() first or pass model=")
        full_precision_matmul()
        data = as_dataset(data)
        parts = _to_device(data.parts, model.device)
        return model_predict(model, model.encode(*parts), probes=probes)
