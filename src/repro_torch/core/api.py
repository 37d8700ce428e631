"""One estimator facade + pluggable stage protocols, for in-core dense data.

The counterpart of ``repro.core.api``::

    from repro_torch import GEEK, DenseData, GeekConfig, predict

    est = GEEK(GeekConfig(k_max=256))            # runs on cuda
    model = est.fit(DenseData(x), 0)             # seed or torch.Generator
    labels, dists = predict(model, new_x)

Underneath, the paper's three stages are the reference's protocols:
``LSHBucketer`` (QALSH rank partition), ``SILKSeeder`` and
``KernelAssigner``. Randomness is drawn in one place,
``LSHBucketer.split_key``, from a ``torch.Generator``: the projection
matrix ``a`` and the SILK table keys. ``discover`` takes those arrays as
arguments, so a caller can hand it arrays drawn elsewhere (the parity
tests hand it the reference's JAX-drawn ones).

Not ported yet, and refused with ``NotImplementedError``: ``mesh=``
(ROADMAP.md Queue 1 item 12), ``chunk=`` / ``seed_cap=`` (item 11),
``batch=`` (item 13), ``probes=`` (item 9), and the hetero and sparse
data kinds (item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch

from repro_torch.core import assign as assign_mod
from repro_torch.core import lsh
from repro_torch.core.buckets import BucketTables, partition_even
from repro_torch.core.geek import GeekConfig, GeekResult, _seed_dense
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


def as_dataset(data) -> DenseData:
    """Coerce fit/predict input to a ``DenseData`` spec."""
    if isinstance(data, DenseData):
        return data
    if hasattr(data, "shape") and len(data.shape) == 2:
        return DenseData(data)
    raise TypeError(f"expected DenseData or an (n, d) array, got "
                    f"{type(data).__name__} (hetero and sparse data are "
                    "not ported yet: ROADMAP.md, Queue 1 item 8)")


# ---------------------------------------------------------------------------
# Stage protocols
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LSHBucketer:
    """The paper's LSH bucket layer for dense data: QALSH projections,
    even rank partition into ``t`` buckets per table."""

    name: ClassVar[str] = "lsh"

    def split_key(self, kind: str, gen: torch.Generator, d: int,
                  cfg: GeekConfig):
        """Draw the fit's randomness: ``((a,), table_keys)``.

        The counterpart of ``repro``'s ``split_key``, which splits a JAX
        key; here the arrays themselves are drawn, in one place: the
        (d, m) QALSH matrix, then the (silk_l + 1, silk_k, 2) SILK table
        keys that the seeder consumes.
        """
        if kind != "dense":
            raise _not_ported(f"{kind!r} data", 8)
        a = lsh.qalsh_projections(gen, d, cfg.m)
        table_keys = derive_hash_keys(gen, (cfg.silk_l + 1, cfg.silk_k))
        return (a,), table_keys

    def fit_transform(self, kind: str, parts: tuple, cfg: GeekConfig):
        """The persistent raw→space transform: the identity for dense."""
        del parts, cfg
        if kind != "dense":
            raise _not_ported(f"{kind!r} data", 8)
        return IdentityTransform()

    def buckets(self, kind: str, space: torch.Tensor, bkeys: tuple,
                cfg: GeekConfig) -> BucketTables:
        """Bucket the space: QALSH hash, then the even rank partition."""
        del kind
        (a,) = bkeys
        return partition_even(lsh.qalsh_hash(space, a.to(space.dtype)), cfg.t)

    def metric(self, kind: str) -> str:
        """Assignment metric for one data kind."""
        del kind
        return "l2"

    def code_bits(self, kind: str, parts: tuple, cfg: GeekConfig) -> int:
        """Static code-width bound (none for dense)."""
        del kind, parts, cfg
        return 0


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
    """Central vectors + the one-pass assignment that fit and predict
    share."""

    name: ClassVar[str] = "kernel"

    def build(self, space: torch.Tensor, seeds: Seeds, cfg: GeekConfig, *,
              metric: str, bits: int, transform, bucketer_id: str = "",
              seeder_id: str = "") -> GeekModel:
        """Centers + model for one fit — everything but the n-sized pass."""
        del metric, bits
        _, _, model = _seed_dense(space, seeds, cfg, transform=transform,
                                  bucketer_id=bucketer_id, seeder_id=seeder_id)
        return model

    def assign(self, model: GeekModel, space: torch.Tensor):
        """One-pass assignment: ``model.predict``'s code path."""
        return model_predict(model, space)


# ---------------------------------------------------------------------------
# Discovery + the in-core fit body
# ---------------------------------------------------------------------------

def discover(kind: str, parts: tuple, cfg: GeekConfig, bucketer, seeder, *,
             bkeys: tuple, skeys: torch.Tensor):
    """Stage 1 + 2: fit the transform, bucket, seed.

    ``bkeys`` / ``skeys`` are the drawn arrays (``LSHBucketer.split_key``).
    Returns ``(transform, space, seeds, overflow)``.
    """
    transform = bucketer.fit_transform(kind, parts, cfg)
    space = transform(*parts)
    buckets = bucketer.buckets(kind, space, bkeys, cfg)
    seeds, overflow = seeder.seed(space, buckets, skeys, cfg)
    return transform, space, seeds, overflow


def _fit_incore(parts: tuple, bkeys: tuple, skeys: torch.Tensor, *,
                cfg: GeekConfig, kind: str, bucketer, seeder, assigner
                ) -> tuple[GeekResult, GeekModel]:
    """In-core fit: discover + build + ONE assignment pass."""
    transform, space, seeds, overflow = discover(kind, parts, cfg, bucketer,
                                                 seeder, bkeys=bkeys,
                                                 skeys=skeys)
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
    """The GEEK estimator for in-core dense data.

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
        """Fit the pipeline on in-core dense data.

        Parameters
        ----------
        data : DenseData or (n, d) array / tensor
            Moved to the estimator's device as float32.
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
        parts = tuple(torch.as_tensor(p, device=self.device).to(torch.float32)
                      for p in data.parts)
        bkeys, skeys = self.bucketer.split_key(data.kind, self._generator(seed),
                                               parts[0].shape[1], self.cfg)
        result, model = _fit_incore(parts, bkeys, skeys, cfg=self.cfg,
                                    kind=data.kind, bucketer=self.bucketer,
                                    seeder=self.seeder,
                                    assigner=self.assigner)
        self.result_, self.model_ = result, model
        return model

    def predict(self, data, *, model: GeekModel | None = None, mesh=None,
                batch: int | None = None, probes: int | None = None):
        """Assign new rows with the fitted (or given) model."""
        if mesh is not None:
            raise _not_ported("sharded serving (mesh=)", 12)
        if batch is not None:
            raise _not_ported("partial-batch serving (batch=)", 13)
        if model is None:
            model = self.model_
        if model is None:
            raise ValueError("not fitted: call fit() first or pass model=")
        full_precision_matmul()
        return model_predict(model, model.encode(*as_dataset(data).parts),
                             probes=probes)
