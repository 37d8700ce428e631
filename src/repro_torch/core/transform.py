"""Transform protocol — the persistent fit-time data transformation.

The counterpart of ``repro.core.transform``. GEEK maps every data type
into a space its one-pass assignment understands (paper §3.1):

  - ``IdentityTransform``  — dense L2 (``encode(x) == x``)
  - ``HeteroTransform``    — persisted ``NumericDiscretizer`` quantile
                             boundaries ++ raw categorical columns
  - ``SparseTransform``    — DOPH under the fit-time hash pair

Coding is row-independent for all three. ``transform_meta`` /
``transform_arrays`` / ``transform_from`` are the checkpoint hooks.

The sparse transform differs from the reference in what it persists.
``repro`` keeps a JAX PRNG key and derives the DOPH hash pair from it
inside ``doph_codes``; the port cannot derive that pair without
``jax.random``, so it keeps the derived (a, b) pair itself, under the
checkpoint leaf ``transform_doph_hash``. A checkpoint written by
``repro`` (leaf ``transform_doph_key``) restores with a transform that
cannot code raw sets (``encode`` raises and says why); its model still
predicts on pre-coded 16-bit codes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import lsh
from repro_torch.core.model import NumericDiscretizer


@dataclasses.dataclass(frozen=True)
class IdentityTransform:
    """Dense data is already in assignment space."""
    kind = "identity"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Pass (n, d) dense rows through unchanged."""
        return x


@dataclasses.dataclass(frozen=True)
class HeteroTransform:
    """Unified categorical codes: discretized numeric ++ raw categorical.

    ``discretizer`` holds the fit-time quantile boundaries (None when the
    data has no numeric columns).
    """
    discretizer: NumericDiscretizer | None
    kind = "hetero"

    def __call__(self, x_num: torch.Tensor | None,
                 x_cat: torch.Tensor | None) -> torch.Tensor:
        """(n, d_num) floats and/or (n, d_cat) ints -> (n, d_num + d_cat)
        int32 codes, row-independent."""
        parts = []
        if self.discretizer is not None:
            if x_num is None:
                raise ValueError("model was fitted with numeric columns; "
                                 "x_num is required")
            parts.append(self.discretizer(x_num))
        elif x_num is not None and x_num.shape[1] > 0:
            raise ValueError("model was fitted without numeric columns but "
                             "x_num has some — refusing to drop them")
        if x_cat is not None and x_cat.shape[1] > 0:
            parts.append(x_cat.to(torch.int32))
        if not parts:
            raise ValueError("hetero transform got no columns")
        return torch.cat(parts, dim=1)


@dataclasses.dataclass(frozen=True)
class SparseTransform:
    """16-bit truncated DOPH codes under the fit-time hash pair.

    ``doph_hash`` is the (2,) uint32 (a, b) pair in the int64 carrier, or
    None for a model restored from a ``repro`` checkpoint, which keeps a
    JAX PRNG key instead (module docstring).
    """
    doph_hash: torch.Tensor | None
    doph_m: int = 64
    kind = "sparse"

    def __call__(self, sets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(n, s_max) padded set items + (n, s_max) bool mask -> (n, doph_m)
        int32 codes (the top 16 bits of the DOPH hash)."""
        if self.doph_hash is None:
            raise ValueError(
                "this sparse model was restored from a checkpoint of the JAX "
                "package, which stores a JAX PRNG key (transform_doph_key) "
                "that the port cannot turn into the DOPH hash pair without "
                "jax.random; pass pre-coded 16-bit DOPH codes to predict()")
        codes = lsh.doph_codes(sets, mask, self.doph_hash, self.doph_m)
        return (codes >> 16).to(torch.int32)


# ---------------------------------------------------------------------------
# Checkpoint (de)serialization — used by checkpoint.manager
# ---------------------------------------------------------------------------

def transform_meta(t) -> dict:
    """JSON-serializable static half of a transform."""
    meta = {"kind": t.kind}
    if isinstance(t, SparseTransform):
        meta["doph_m"] = t.doph_m
    return meta


def transform_arrays(t) -> dict:
    """Array half of a transform, by stable name (checkpoint leaves)."""
    if isinstance(t, HeteroTransform) and t.discretizer is not None:
        return {"boundaries": t.discretizer.boundaries}
    if isinstance(t, SparseTransform):
        if t.doph_hash is None:
            raise ValueError("a sparse transform restored from a JAX "
                             "checkpoint has no DOPH hash pair to save")
        # uint32 on disk, as the reference writes its hash keys
        return {"doph_hash": t.doph_hash.cpu().numpy().astype(np.uint32)}
    return {}


def transform_from(meta: dict, arrays: dict, device=None):
    """Rebuild a transform from its meta + arrays (checkpoint restore),
    its arrays on ``device``."""
    kind = meta["kind"]
    if kind == "identity":
        return IdentityTransform()
    if kind == "hetero":
        b = arrays.get("boundaries")
        return HeteroTransform(None if b is None else NumericDiscretizer(
            torch.as_tensor(b, device=device).to(torch.float32)))
    if kind == "sparse":
        h = arrays.get("doph_hash")
        if h is not None:
            h = torch.as_tensor(np.asarray(h).astype(np.int64), device=device)
        return SparseTransform(h, int(meta["doph_m"]))
    raise ValueError(f"unknown transform kind {kind!r}")
