"""Transform protocol — the persistent fit-time data transformation.

The counterpart of ``repro.core.transform``. GEEK maps every data type
into a space its one-pass assignment understands (paper §3.1):

  - ``IdentityTransform``  — dense L2 (``encode(x) == x``)
  - ``HeteroTransform``    — persisted ``NumericDiscretizer`` quantile
                             boundaries ++ raw categorical columns
  - ``SparseTransform``    — DOPH under the fit-time hash pair

Coding is row-independent for all three. ``transform_meta`` /
``transform_arrays`` / ``transform_from`` are the checkpoint hooks.

The sparse transform persists what the reference persists: the raw
(2,) uint32 JAX key ``doph_key``, from which ``encode`` derives the DOPH
hash pair as ``repro``'s ``lsh.doph_codes`` does
(``utils.hashing.derive_hash_keys_from_key``, the partitionable
Threefry-2x32 of jax 0.9, reproduced bit for bit). Checkpoints therefore
cross both ways: the leaf ``transform_doph_key`` is the reference's. An
older port checkpoint that stored the derived pair itself (leaf
``transform_doph_hash``) still restores and codes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import lsh
from repro_torch.core.model import NumericDiscretizer
from repro_torch.utils.hashing import derive_hash_keys_from_key


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
    """16-bit truncated DOPH codes under the fit-time key.

    ``doph_key`` is the raw (2,) uint32 JAX key in the int64 carrier; the
    DOPH hash pair is derived from it on every call, as the reference
    does. ``doph_hash`` is set instead only for a model restored from an
    older port checkpoint that stored the derived pair (module docstring).
    """
    doph_key: torch.Tensor | None
    doph_m: int = 64
    doph_hash: torch.Tensor | None = None
    kind = "sparse"

    def hash_pair(self) -> torch.Tensor:
        """The (1, 2) DOPH (a, b) pair in the int64 carrier."""
        if self.doph_hash is not None:
            return self.doph_hash
        return derive_hash_keys_from_key(self.doph_key, (1,))

    def __call__(self, sets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(n, s_max) padded set items + (n, s_max) bool mask -> (n, doph_m)
        int32 codes (the top 16 bits of the DOPH hash)."""
        codes = lsh.doph_codes(sets, mask, self.hash_pair(), self.doph_m)
        return (codes >> 16).to(torch.int32)


# ---------------------------------------------------------------------------
# Checkpoint (de)serialization — used by checkpoint.manager
# ---------------------------------------------------------------------------

def transform_meta(t) -> dict:
    """JSON-serializable static half of a transform."""
    meta = {"kind": t.kind}
    if isinstance(t, SparseTransform):
        meta["doph_m"] = t.doph_m
        if t.doph_key is not None:
            meta["typed_key"] = False   # the raw key data, as repro reads it
    return meta


def transform_arrays(t) -> dict:
    """Array half of a transform, by stable name (checkpoint leaves)."""
    if isinstance(t, HeteroTransform) and t.discretizer is not None:
        return {"boundaries": t.discretizer.boundaries}
    if isinstance(t, SparseTransform):
        # uint32 on disk, as the reference writes its raw keys
        if t.doph_key is not None:
            return {"doph_key": t.doph_key.cpu().numpy().astype(np.uint32)}
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
        # the reference's raw or typed key (its leaf holds the key data
        # either way), or an older port checkpoint's derived pair
        def carried(name):
            a = arrays.get(name)
            return None if a is None else torch.as_tensor(
                np.asarray(a).astype(np.int64), device=device)
        key, pair = carried("doph_key"), carried("doph_hash")
        if key is None and pair is None:
            raise ValueError("sparse transform checkpoint has neither "
                             "transform_doph_key nor transform_doph_hash")
        return SparseTransform(key, int(meta["doph_m"]),
                               doph_hash=None if key is not None else pair)
    raise ValueError(f"unknown transform kind {kind!r}")
