"""Refit-and-publish autopilot: serve v_N while fitting v_N+1.

The counterpart of ``repro.serve.autopilot``. A ``RefitAutopilot``
watches served traffic (the HTTP front end feeds its ``observe`` as the
request observer; any stream can call it directly), keeps a uniform
reservoir of recent rows, and periodically:

1. **refits** through the ``GEEK`` facade, on the serving device, in its
   own thread while the serving worker keeps launching on the same card:
   SILK's k-free seeding lets the republished model's k* track the
   traffic;
2. **validates** the candidate before anyone serves it, through named
   gates: ``k_star`` (in bounds), ``coverage`` (no row overflowed the
   static budgets), ``self_assign`` (``predict`` of the candidate on a
   holdout slice of its own fit rows reproduces the fit labels bit for
   bit), plus an optional caller gate;
3. **publishes** through ``server.swap`` only when every gate passes (on
   the card, once the refit thread's stream has finished writing the
   model), and **rolls back** otherwise: the candidate is dropped, the
   incumbent keeps serving, and the rejection (gate names included)
   lands in ``stats()["last_rejection"]``.

``run_once()`` is the whole cycle, synchronous; ``start()`` runs it on a
wall-clock period in a daemon thread.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.serve.engine import _host_array
from repro_torch.serve.registry import _transform_kind
from repro_torch.utils.device import indexed, parts_to_device


def _dataset_for(kind: str, parts: tuple):
    """Wrap reservoir parts in the facade's Dataset spec for ``kind``."""
    from repro_torch.core.api import DenseData, HeteroData, SparseData
    if kind == "identity":
        return DenseData(parts[0])
    if kind == "hetero":
        return HeteroData(parts[0], parts[1])
    return SparseData(parts[0], parts[1])


class RefitAutopilot:
    """Reservoir + background refit + validated publish (with rollback).

    Parameters
    ----------
    server : ClusterServer or WorkerPool
        The serving engine to republish through (``swap``). Its
        registry is the rollback boundary: nothing is published until
        validation passes.
    cfg : GeekConfig
        Fit configuration for every refit (k* is discovered per refit;
        ``cfg.k_max`` is its static budget, not a choice of k).
    reservoir : int
        Row capacity of the traffic reservoir (uniform over everything
        observed since the last refit drain — classic Algorithm-R,
        vectorized).
    min_rows : int
        Refits are skipped (not failed) below this many reservoir rows
        — a refit on 12 rows would "validate" and publish garbage.
    holdout : int
        Rows of the fit reservoir re-predicted for the ``self_assign``
        gate.
    refit_every_s : float or None
        Wall-clock refit period for ``start()``; ``None`` means the
        autopilot only refits when ``run_once()`` is called.
    validator : callable or None
        Optional extra gate ``(model, result, parts) -> (ok, reason)``
        evaluated after the built-in gates (fault-injection tests use
        this to force a rollback).
    seed : int
        Base seed; refit *i* fits with seed ``seed + i`` so cycles are
        reproducible.
    max_k_star : int or None
        Upper bound for the ``k_star`` gate (default ``cfg.k_max``).

    Notes
    -----
    ``observe(parts)`` is thread-safe and cheap (numpy slicing under a
    lock); it is safe to call from HTTP handler threads. ``run_once``
    serializes refits with an internal lock — a second caller skips
    instead of stacking fits.
    """

    def __init__(self, server, cfg, *, reservoir: int = 8192,
                 min_rows: int = 256, holdout: int = 128,
                 refit_every_s: float | None = None, validator=None,
                 seed: int = 0, max_k_star: int | None = None):
        if reservoir < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir}")
        self.server = server
        self.cfg = cfg
        self.capacity = int(reservoir)
        self.min_rows = int(min_rows)
        self.holdout = int(holdout)
        self.refit_every_s = refit_every_s
        self.validator = validator
        self.seed = int(seed)
        self.max_k_star = (int(cfg.k_max) if max_k_star is None
                           else int(max_k_star))
        self.kind = _transform_kind(server.model)
        # refits run where the served model lives
        self.device = indexed(server.model.device)
        self._lock = threading.Lock()          # reservoir state
        self._fit_lock = threading.Lock()      # one refit at a time
        self._buffers: list | None = None      # per-part (capacity, ...) rows
        self._filled = 0
        self._seen = 0
        self._rng = np.random.default_rng(self.seed)
        self._stats = {"observed_rows": 0, "refits": 0, "published": 0,
                       "rollbacks": 0, "skipped": 0}
        self._last_rejection: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- traffic intake ------------------------------------------------------

    def observe(self, parts) -> None:
        """Feed served rows into the reservoir (uniform sampling).

        ``parts`` uses the same layout as ``ClusterServer.submit``. The
        reservoir stays a uniform sample of all rows observed since the
        last drain: the first ``capacity`` rows fill it, each later row
        t replaces a uniform slot with probability ``capacity / t``
        (Algorithm R, vectorized per batch).
        """
        if not isinstance(parts, (tuple, list)):
            parts = (parts,)
        parts = tuple(None if p is None else _host_array(p) for p in parts)
        n = next(int(p.shape[0]) for p in parts if p is not None)
        with self._lock:
            if self._buffers is None:
                self._buffers = [
                    None if p is None else
                    np.empty((self.capacity,) + p.shape[1:], p.dtype)
                    for p in parts]
            take = min(n, self.capacity - self._filled)
            if take:
                for buf, p in zip(self._buffers, parts):
                    if buf is not None:
                        buf[self._filled:self._filled + take] = p[:take]
                self._filled += take
            if n > take:
                # vectorized Algorithm R over the remaining rows: row t
                # (1-based over everything seen) lands on uniform slot
                # j ~ U[0, t); it stays only if j < capacity
                t = self._seen + np.arange(take + 1, n + 1, dtype=np.int64)
                slot = (self._rng.random(n - take) * t).astype(np.int64)
                keep = slot < self.capacity
                for buf, p in zip(self._buffers, parts):
                    if buf is not None:
                        buf[slot[keep]] = p[take:][keep]
            self._seen += n
            self._stats["observed_rows"] += n

    def _snapshot(self) -> tuple | None:
        """Copy the current reservoir rows (None when below min_rows)."""
        with self._lock:
            if self._buffers is None or self._filled < self.min_rows:
                return None
            return tuple(None if b is None else b[:self._filled].copy()
                         for b in self._buffers)

    # -- the refit cycle -----------------------------------------------------

    def _validate(self, model, result, parts: tuple) -> list[str]:
        """Run every gate; returns the names of the gates that FAILED."""
        failed = []
        k_star = int(model.k_star)
        if not 1 <= k_star <= self.max_k_star:
            failed.append(f"k_star ({k_star} outside [1, "
                          f"{self.max_k_star}])")
        n = int(result.labels.shape[0])
        covered = n - int(result.overflow)
        coverage = covered / max(n, 1)
        if coverage < 1.0:
            failed.append(f"coverage ({coverage:.4f} < 1.0: "
                          f"{int(result.overflow)} rows overflowed the "
                          "static budgets)")
        h = min(self.holdout, n)
        from repro_torch.core.model import predict
        want = result.labels[:h].cpu().numpy()
        got = predict(model, model.encode(*parts_to_device(
            tuple(None if p is None else p[:h] for p in parts),
            model.device)))[0].cpu().numpy()
        if not np.array_equal(got, want):
            failed.append(f"self_assign ({int((got != want).sum())}/{h} "
                          "holdout rows disagree with fit labels)")
        if self.validator is not None:
            ok, reason = self.validator(model, result, parts)
            if not ok:
                failed.append(f"custom ({reason})")
        return failed

    def run_once(self) -> int | None:
        """One full cycle: snapshot -> fit -> validate -> publish/rollback.

        Returns the published version, or ``None`` when the cycle was
        skipped (too few rows / a refit already running) or rolled
        back (see ``stats()["last_rejection"]``).
        """
        if not self._fit_lock.acquire(blocking=False):
            with self._lock:
                self._stats["skipped"] += 1
            return None
        try:
            parts = self._snapshot()
            if parts is None:
                with self._lock:
                    self._stats["skipped"] += 1
                return None
            with self._lock:
                self._stats["refits"] += 1
                cycle = self._stats["refits"]
            from repro_torch.core.api import GEEK
            est = GEEK(self.cfg, device=self.device)
            model = est.fit(_dataset_for(self.kind, parts),
                            self.seed + cycle)
            if self.device.type == "cuda":
                # this thread's stream wrote the model: let it finish
                # before any server stream reads it
                torch.cuda.current_stream(self.device).synchronize()
            failed = self._validate(model, est.result_, parts)
            if not failed:
                try:
                    version = self.server.swap(model)
                except ValueError as e:     # registry refused (kind/width)
                    failed = [f"publish ({e})"]
                else:
                    with self._lock:
                        self._stats["published"] += 1
                    return version
            # rollback: the candidate is dropped, the incumbent serves on
            with self._lock:
                self._stats["rollbacks"] += 1
                self._last_rejection = {
                    "cycle": cycle,
                    "gates": failed,
                    "k_star": int(model.k_star),
                    "incumbent_version": self.server.version,
                }
            return None
        finally:
            self._fit_lock.release()

    # -- background loop -----------------------------------------------------

    def start(self) -> "RefitAutopilot":
        """Refit every ``refit_every_s`` seconds until ``close()``."""
        if self.refit_every_s is None:
            raise ValueError("start() needs refit_every_s (or drive "
                             "run_once() yourself)")
        if self._thread is not None:
            raise RuntimeError("autopilot already started")

        def loop():
            """Run one refit cycle per period; never let the clock die."""
            while not self._stop.wait(self.refit_every_s):
                try:
                    self.run_once()
                except Exception:      # noqa: BLE001 — keep the clock alive
                    with self._lock:
                        self._stats["rollbacks"] += 1
                        self._last_rejection = {"gates": ["refit raised"]}

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="repro-torch-serve-autopilot")
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop the background clock (a running refit finishes first)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stats(self) -> dict:
        """Counters + the last rejection (why the last rollback rolled)."""
        with self._lock:
            out = dict(self._stats)
            out["reservoir_rows"] = self._filled
            out["last_rejection"] = (dict(self._last_rejection)
                                     if self._last_rejection else None)
            return out
