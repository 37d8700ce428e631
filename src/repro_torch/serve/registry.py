"""Multi-model registry with atomic hot-swap.

The counterpart of ``repro.serve.registry``: a named, versioned,
thread-safe map of fitted ``GeekModel``s. The engine
(``repro_torch.serve.engine``) reads ``current(name)`` exactly once per
micro-batch, so a swap is atomic *between* micro-batches: in-flight
requests finish on the model they were batched under, and no micro-batch
mixes two versions.

Models arrive in memory (``publish``) or from a checkpoint directory
(``load``: ``repro_torch.checkpoint.manager.restore_model``, which reads
either package's checkpoints), so a fitting process and a serving process
need only share a directory. A publisher hands over a model whose tensors
are written: on the card, synchronize the stream that made them first.
"""
from __future__ import annotations

import threading
from typing import NamedTuple


class ModelRecord(NamedTuple):
    """One published model version.

    Attributes
    ----------
    version : int
        Monotonic per-name version number (0 for the first publish).
    model : repro_torch.core.model.GeekModel
        The fitted model itself.
    source : str
        Provenance ("" for in-memory publishes, the checkpoint directory
        for ``load``).
    """

    version: int
    model: object
    source: str = ""


def _transform_kind(model) -> str:
    """The model's traffic kind ("identity" / "hetero" / "sparse")."""
    return getattr(model.transform, "kind", "identity")


class ModelRegistry:
    """Named, versioned model store with atomic reads.

    All methods are thread-safe; ``current`` is one dict read under the
    lock, so the engine's per-micro-batch snapshot is atomic with respect
    to concurrent ``publish`` / ``load`` calls.
    """

    def __init__(self, *, keep: int = 2):
        """``keep``: live versions retained per name (older ones are
        dropped once newer ones are published; an in-flight micro-batch
        holds its own reference, so dropping early is safe)."""
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._lock = threading.RLock()
        self._records: dict[str, list[ModelRecord]] = {}
        self._keep = keep

    # -- write ---------------------------------------------------------------

    def publish(self, name: str, model, *, source: str = "",
                check_compatible: bool = True) -> int:
        """Publish a model version under ``name``; returns its version.

        With ``check_compatible`` (the default) a model whose transform
        kind or feature width differs from the current version's is
        refused: its traffic could not be served by both.
        """
        with self._lock:
            records = self._records.setdefault(name, [])
            if records and check_compatible:
                cur = records[-1].model
                old_kind, new_kind = _transform_kind(cur), \
                    _transform_kind(model)
                if old_kind != new_kind:
                    raise ValueError(
                        f"hot-swap kind mismatch for {name!r}: serving a "
                        f"{old_kind!r} model, refusing to publish a "
                        f"{new_kind!r} one (pass check_compatible=False "
                        "to repurpose the name)")
                if cur.d != model.d:
                    raise ValueError(
                        f"hot-swap width mismatch for {name!r}: current "
                        f"model codes d={cur.d}, new model d={model.d}")
            version = records[-1].version + 1 if records else 0
            records.append(ModelRecord(version, model, source))
            del records[:-self._keep]
            return version

    def load(self, name: str, directory: str, *, step: int | None = None,
             mesh=None, device=None, check_compatible: bool = True) -> int:
        """Restore a checkpointed model on ``device`` (``restore_model``'s
        default: the card) and publish it under ``name``.

        The restore happens OUTSIDE the registry lock (file reads and the
        index rebuild take a while; readers must not stall), then the
        publish itself is atomic.
        """
        from repro_torch.checkpoint.manager import restore_model
        model = restore_model(directory, step=step, mesh=mesh, device=device)
        return self.publish(name, model, source=directory,
                            check_compatible=check_compatible)

    # -- read ----------------------------------------------------------------

    def current(self, name: str) -> ModelRecord:
        """The newest record for ``name`` (the engine's per-batch snapshot)."""
        with self._lock:
            records = self._records.get(name)
            if not records:
                raise KeyError(f"no model published under {name!r}")
            return records[-1]

    def get(self, name: str, version: int) -> ModelRecord:
        """A specific retained version (KeyError if dropped or unknown)."""
        with self._lock:
            for rec in self._records.get(name, ()):
                if rec.version == version:
                    return rec
        raise KeyError(f"{name!r} has no retained version {version}")

    def versions(self, name: str) -> list[int]:
        """Retained version numbers for ``name``, oldest first."""
        with self._lock:
            return [r.version for r in self._records.get(name, ())]

    def names(self) -> list[str]:
        """All names with at least one published version, sorted."""
        with self._lock:
            return sorted(n for n, r in self._records.items() if r)
