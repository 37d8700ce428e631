"""Transform protocol — the persistent fit-time data transformation.

The counterpart of ``repro.core.transform`` for dense data: the
identity, plus the checkpoint hooks ``transform_meta`` /
``transform_arrays`` / ``transform_from``. The hetero and sparse
transforms come with the code spaces (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses

import torch

_CODE_SPACES = ("the hetero and sparse transforms are not ported yet "
                "(ROADMAP.md, Queue 1 item 8: code spaces)")


@dataclasses.dataclass(frozen=True)
class IdentityTransform:
    """Dense data is already in assignment space."""
    kind = "identity"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Pass (n, d) dense rows through unchanged."""
        return x


def transform_meta(t) -> dict:
    """JSON-serializable static half of a transform."""
    if not isinstance(t, IdentityTransform):
        raise NotImplementedError(_CODE_SPACES)
    return {"kind": t.kind}


def transform_arrays(t) -> dict:
    """Array half of a transform, by stable name (checkpoint leaves)."""
    if not isinstance(t, IdentityTransform):
        raise NotImplementedError(_CODE_SPACES)
    return {}


def transform_from(meta: dict, arrays: dict):
    """Rebuild a transform from its meta + arrays (checkpoint restore)."""
    del arrays
    kind = meta["kind"]
    if kind == "identity":
        return IdentityTransform()
    if kind in ("hetero", "sparse"):
        raise NotImplementedError(_CODE_SPACES)
    raise ValueError(f"unknown transform kind {kind!r}")
