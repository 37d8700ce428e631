"""GeekModel — the persistent fitted state of a GEEK run, for metric l2.

The counterpart of ``repro.core.model``: the central vectors plus the
metadata needed to assign new points with the same one-pass kernel.
``predict(model, x)`` is the serving-side twin of the fit-time
assignment, one code path, so predict on the fit rows reproduces the fit
labels exactly.

Not ported yet: the center index (``probes=``, ROADMAP.md Queue 1 item
9) and the Hamming metrics (Queue 1 item 8). ``index_tables``,
``index_bucket`` and ``use_pallas`` stay in the metadata so checkpoints
round-trip with ``repro``; in the port the device, not ``use_pallas``,
picks the route: on the card ``predict_l2`` always runs the kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.transform import IdentityTransform
from repro_torch.kernels import ops as kops

#: canonical fields persisted by the checkpoint manager, in manifest order
ARRAY_FIELDS = ("centers", "center_valid", "k_star", "radius")


@dataclasses.dataclass(frozen=True)
class GeekModel:
    """The persistent fitted state of a GEEK run (module docstring)."""

    # -- canonical fitted state (serialized) --------------------------------
    centers: torch.Tensor        # (k_max, d) float32 centroids
    center_valid: torch.Tensor   # (k_max,) bool
    k_star: torch.Tensor         # () int32 — discovered #clusters
    radius: torch.Tensor         # (k_max,) per-cluster max distance at fit
    transform: object = IdentityTransform()   # the fit-time transform
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
        """Code raw inputs into the model's assignment space."""
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
    """Construct a GeekModel: the one constructor of every fit path and of
    checkpoint restore. Only ``metric="l2"`` is ported."""
    if metric == "hamming":
        raise NotImplementedError("Hamming models are not ported yet "
                                  "(ROADMAP.md, Queue 1 item 8: code spaces)")
    if metric != "l2":
        raise ValueError(f"unknown metric {metric!r}")
    return GeekModel(centers, center_valid, k_star, radius,
                     IdentityTransform() if transform is None else transform,
                     metric, "", int(code_bits), int(centers.shape[1]),
                     int(assign_block), bool(use_pallas), bucketer_id,
                     seeder_id, int(index_tables), int(index_bucket))


def predict_l2(model: GeekModel, x: torch.Tensor):
    """L2 assignment, shared by ``predict`` and the fit-time pass.

    Returns (n,) int32 labels and (n,) float32 Euclidean distances.
    """
    labels, d2 = kops.distance_argmin_l2(x, model.centers, model.center_valid,
                                         block=model.assign_block)
    return labels, torch.sqrt(d2)


def predict(model: GeekModel, x, probes: int | None = None):
    """One-pass assignment of new points against a fitted model.

    ``x`` is (n, d) floats, moved to the model's device as float32: the
    model's device (the fit's, or restore's ``device``) is where predict
    runs. ``probes`` (the center index) is not ported yet. Returns
    (labels, dists); on the fit rows the labels equal the fit labels.
    """
    if probes is not None:
        raise NotImplementedError("predict(probes=...) needs the center index "
                                  "(ROADMAP.md, Queue 1 item 9)")
    x = torch.as_tensor(x, device=model.device).to(torch.float32)
    if x.ndim != 2 or x.shape[1] != model.d:
        raise ValueError(f"expected (n, {model.d}) input, got {tuple(x.shape)}")
    return predict_l2(model, x)
