"""GeekModel — the persistent fitted state of a GEEK run.

The counterpart of ``repro.core.model``: the central vectors (centroids
for l2, per-attribute mode codes for hamming) plus the metadata needed
to assign new points with the same one-pass kernels, and the numeric
discretizer of the hetero transform. ``predict(model, x)`` is the
serving-side twin of the fit-time assignment, one code path, so predict
on the fit rows reproduces the fit labels exactly. Centers are packed
once at build time (bit-packed words, or one-hot rows), so a predict
call packs only the incoming batch.

Not ported yet: the center index (``probes=``, ROADMAP.md Queue 1 item
9). ``index_tables``, ``index_bucket`` and ``use_pallas`` stay in the
metadata so checkpoints round-trip with ``repro``; in the port the
device, not ``use_pallas``, picks the route: on the card the L2, the
equality and the packed assignment always run their kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.pack import onehot_codes, pack_codes

#: canonical fields persisted by the checkpoint manager, in manifest order
ARRAY_FIELDS = ("centers", "center_valid", "k_star", "radius")


# ---------------------------------------------------------------------------
# Numeric discretization with persisted quantile boundaries
# ---------------------------------------------------------------------------

def quantile_boundaries(v_sorted: torch.Tensor, t_cat: int) -> torch.Tensor:
    """(d, t_cat - 1) bin boundaries from per-attribute ascending-sorted
    (n, d) values.

    Boundary b (1-based) is the value at rank ``ceil(b*n/t_cat)``; ranks
    beyond n-1 (empty tail bins when n < t_cat) become +inf.
    """
    n = v_sorted.shape[0]
    r = (np.arange(1, t_cat) * n + t_cat - 1) // t_cat
    picked = v_sorted[torch.as_tensor(np.minimum(r, n - 1),
                                      device=v_sorted.device)]
    tail = torch.as_tensor((r >= n)[:, None], device=v_sorted.device)
    return torch.where(tail, torch.inf, picked).T.contiguous()


@dataclasses.dataclass(frozen=True)
class NumericDiscretizer:
    """Per-attribute quantile bin boundaries, fitted once and persisted.

    Codes are ``searchsorted(boundaries[j], x[:, j], right=True)`` per
    attribute, so coding a point depends only on the fitted boundaries,
    never on the batch it arrives in.
    """
    boundaries: torch.Tensor    # (d_num, t_cat - 1) float32, rows ascending

    @property
    def d_num(self) -> int:
        """Number of numeric attributes the boundaries were fitted on."""
        return self.boundaries.shape[0]

    @property
    def t_cat(self) -> int:
        """Number of discretization bins (boundaries + 1)."""
        return self.boundaries.shape[1] + 1

    @classmethod
    def fit(cls, x_num: torch.Tensor, t_cat: int) -> "NumericDiscretizer":
        """Fit per-attribute quantile boundaries from an (n, d_num) batch."""
        return cls(quantile_boundaries(torch.sort(x_num, dim=0).values,
                                       t_cat))

    def __call__(self, x_num: torch.Tensor) -> torch.Tensor:
        """Code a batch: (n, d_num) floats -> (n, d_num) int32 bins."""
        if x_num.ndim != 2 or x_num.shape[1] != self.d_num:
            raise ValueError(f"expected (n, {self.d_num}) numeric input, "
                             f"got {tuple(x_num.shape)}")
        codes = torch.searchsorted(self.boundaries,
                                   x_num.to(self.boundaries.dtype).T
                                   .contiguous(), right=True)
        return codes.T.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class GeekModel:
    """The persistent fitted state of a GEEK run (module docstring)."""

    # -- canonical fitted state (serialized) --------------------------------
    centers: torch.Tensor        # (k_max, d) float32 centroids / int32 modes
    center_valid: torch.Tensor   # (k_max,) bool
    k_star: torch.Tensor         # () int32 — discovered #clusters
    radius: torch.Tensor         # (k_max,) per-cluster max distance at fit
    # -- derived caches (rebuilt from centers, never serialized) -------------
    packed_centers: torch.Tensor | None = None  # (k_max, w) int32 words
    onehot_centers: torch.Tensor | None = None  # (k_max, d * 2**bits) bf16
    transform: object = None     # the fit-time transform (None: pre-coded)
    # -- static dispatch metadata (checkpoint manifest) ----------------------
    metric: str = "l2"
    impl: str = ""
    code_bits: int = 0
    d: int = 0
    assign_block: int = 4096
    use_pallas: bool = False
    bucketer_id: str = ""
    seeder_id: str = ""
    index_tables: int = 8
    index_bucket: int = 32

    @property
    def k_max(self) -> int:
        """Static cluster budget (rows of ``centers``)."""
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        """The device the model's tensors (and its predict) live on."""
        return self.centers.device

    def encode(self, *parts) -> torch.Tensor:
        """Code raw inputs into the model's assignment space: ``(x,)``
        dense, ``(x_num, x_cat)`` hetero, ``(sets, mask)`` sparse."""
        if self.transform is None:
            if len(parts) == 1:
                return parts[0]   # a model without transform takes codes
            raise ValueError("model has no fit-time transform; pass "
                             "pre-transformed codes to predict() instead")
        return self.transform(*parts)

    def static_meta(self) -> dict:
        """JSON-serializable dispatch metadata (checkpoint manifest extra)."""
        return {"metric": self.metric, "impl": self.impl,
                "code_bits": self.code_bits, "d": self.d,
                "assign_block": self.assign_block,
                "use_pallas": self.use_pallas,
                "bucketer_id": self.bucketer_id,
                "seeder_id": self.seeder_id,
                "index_tables": self.index_tables,
                "index_bucket": self.index_bucket}


def build_model(centers: torch.Tensor, center_valid: torch.Tensor,
                k_star: torch.Tensor, radius: torch.Tensor, *,
                metric: str, impl: str = "", code_bits: int = 0,
                assign_block: int = 4096, use_pallas: bool = False,
                transform=None, bucketer_id: str = "", seeder_id: str = "",
                index_tables: int = 8, index_bucket: int = 32) -> GeekModel:
    """Construct a GeekModel, packing centers once for the chosen impl:
    the one constructor of every fit path and of checkpoint restore.

    ``centers`` are centroids (l2) or mode codes (hamming); ``impl`` is
    the resolved Hamming impl ("equality" | "packed" | "onehot"),
    ignored for l2. A hamming model without ``transform`` predicts on
    pre-coded input.
    """
    if metric not in ("l2", "hamming"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "hamming" and impl not in ("equality", "packed", "onehot"):
        raise ValueError(f"unresolved hamming impl {impl!r}")
    packed = onehot = None
    if metric == "hamming":
        if impl == "packed":
            packed = pack_codes(centers, code_bits)
        elif impl == "onehot":
            onehot = onehot_codes(centers, 1 << code_bits)
    if transform is None and metric == "l2":
        from repro_torch.core.transform import IdentityTransform
        transform = IdentityTransform()
    return GeekModel(centers, center_valid, k_star, radius, packed, onehot,
                     transform, metric, impl if metric == "hamming" else "",
                     int(code_bits), int(centers.shape[1]),
                     int(assign_block), bool(use_pallas), bucketer_id,
                     seeder_id, int(index_tables), int(index_bucket))


def predict_l2(model: GeekModel, x: torch.Tensor):
    """L2 assignment, shared by ``predict`` and the fit-time pass.

    Returns (n,) int32 labels and (n,) float32 Euclidean distances.
    """
    labels, d2 = kops.distance_argmin_l2(x, model.centers, model.center_valid,
                                         block=model.assign_block)
    return labels, torch.sqrt(d2)


def predict_hamming(model: GeekModel, codes: torch.Tensor):
    """Hamming assignment (equality / packed / one-hot), shared by
    ``predict`` and the fit-time pass.

    ``codes`` (n, d) int32 in the model's code space. Returns (n,) int32
    labels and (n,) float32 mismatch fractions (counts / d, ≈ 1 −
    Jaccard), as the reference normalizes them.
    """
    from repro_torch.core import assign as assign_mod
    bits, d = model.code_bits, model.d
    if model.impl == "packed":
        labels, dists = kops.distance_argmin_hamming_packed(
            pack_codes(codes, bits), model.packed_centers,
            model.center_valid, bits=bits, d=d, block=model.assign_block)
    elif model.impl == "onehot":
        labels, dists = assign_mod.assign_hamming_onehot(
            codes, model.centers, model.center_valid, card=1 << bits,
            block=model.assign_block, centers_onehot=model.onehot_centers)
    else:
        labels, dists = kops.distance_argmin_hamming(
            codes, model.centers, model.center_valid,
            block=model.assign_block)
    return labels, dists / d


def predict(model: GeekModel, x, probes: int | None = None):
    """One-pass assignment of new points against a fitted model.

    ``x`` is (n, d): dense rows (moved to the model's device as float32)
    or, for a hamming model, codes in its code space (``model.encode``;
    moved as int32). The model's device (the fit's, or restore's
    ``device``) is where predict runs. ``probes`` (the center index) is
    not ported yet. Returns (labels, dists); on the fit rows the labels
    equal the fit labels.
    """
    if probes is not None:
        raise NotImplementedError("predict(probes=...) needs the center index "
                                  "(ROADMAP.md, Queue 1 item 9)")
    dtype = torch.float32 if model.metric == "l2" else torch.int32
    x = torch.as_tensor(x, device=model.device).to(dtype)
    if x.ndim != 2 or x.shape[1] != model.d:
        raise ValueError(f"expected (n, {model.d}) input, got {tuple(x.shape)}")
    if model.metric == "l2":
        return predict_l2(model, x)
    return predict_hamming(model, x)


def update_centers(model: GeekModel, centers: torch.Tensor, *,
                   radius: torch.Tensor | None = None,
                   rebuild_index: bool = False) -> GeekModel:
    """Swap a fitted model's centers (the online-drift hook).

    Streaming consumers (``repro_torch.serve.kv_cluster``) move centers a
    little every step (EMA drift) and a lot every refresh (re-fit). The
    derived packed/one-hot caches are pure functions of the centers, so
    they are re-derived here. ``radius`` replaces the fitted field when
    given. ``rebuild_index`` asks for the center index, which is not
    ported yet: it raises on a model that keeps one (``index_tables >
    0``). Returns a new model; the input is untouched.
    """
    if tuple(centers.shape) != tuple(model.centers.shape):
        raise ValueError(f"centers shape {tuple(centers.shape)} != fitted "
                         f"{tuple(model.centers.shape)}")
    if rebuild_index and model.index_tables > 0:
        raise NotImplementedError("update_centers(rebuild_index=True) needs "
                                  "the center index (ROADMAP.md, Queue 1 "
                                  "item 9)")
    packed, onehot = model.packed_centers, model.onehot_centers
    if model.metric == "hamming":
        if model.impl == "packed":
            packed = pack_codes(centers, model.code_bits)
        elif model.impl == "onehot":
            onehot = onehot_codes(centers, 1 << model.code_bits)
    return dataclasses.replace(
        model, centers=centers,
        radius=model.radius if radius is None else radius,
        packed_centers=packed, onehot_centers=onehot)
