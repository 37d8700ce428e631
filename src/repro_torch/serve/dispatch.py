"""Multi-worker dispatch: one ClusterServer per device.

The counterpart of ``repro.serve.dispatch``. ``WorkerPool`` is N
``ClusterServer``s serving one model name out of one shared
``ModelRegistry``, plus a router:

- **Routing: sticky, then least-queued spill.** Requests stick to the
  current worker until its outstanding rows would exceed ``max_batch``,
  so one worker's micro-batch fills (full buckets are where padding waste
  vanishes); on overflow the router spills to the worker with the fewest
  outstanding rows and sticks there.
- **One registry, one swap point.** ``swap()`` publishes once; every
  worker snapshots ``current(name)`` at its next micro-batch boundary, so
  no request sees a mix of versions.
- **Identity.** Each worker pads and batches as a single server does, so
  pool labels are the direct ``predict`` path's bit for bit.

Each worker owns a device (``devices=``, or the first ``workers`` cards
from ``utils.platform.worker_devices``). Workers may share a card: each
launches on a stream of its own, but one card computes their batches in
turn, so a pool on one card is no faster than one server there.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future

from repro_torch.core.model import GeekModel
from repro_torch.serve.engine import (ClusterServer, ServerClosedError,
                                      _host_array, _written)
from repro_torch.serve.registry import ModelRegistry
from repro_torch.utils.platform import worker_devices


class WorkerPool:
    """N per-device ClusterServers behind one registry and one router.

    Parameters
    ----------
    model_or_ckpt : GeekModel or str
        Model to serve (restored once, on the first worker's device, if a
        checkpoint directory).
    workers : int or None
        Worker count; default: every card (``worker_devices``).
    devices : sequence of str or torch.device, or None
        Explicit devices, one worker each (overrides ``workers``; a
        device may repeat: ``("cpu", "cpu")`` serves on the CPU's plain
        path).
    probes, max_batch, deadline_ms, min_bucket, ladder
        Forwarded to every ``ClusterServer``.
    registry : ModelRegistry or None
        Shared registry; by default the pool owns one.
    name : str
        Registry name all workers serve.

    Notes
    -----
    ``submit`` / ``swap`` / ``warmup`` / ``stats`` / ``close`` mirror the
    single-server surface, so the HTTP front end and the autopilot run
    unchanged against a pool.
    """

    def __init__(self, model_or_ckpt, *, workers: int | None = None,
                 devices=None, probes: int | None = None,
                 max_batch: int = 4096, deadline_ms: float = 5.0,
                 min_bucket: int = 64,
                 ladder: tuple[int, ...] | None = None,
                 registry: ModelRegistry | None = None,
                 name: str = "default"):
        if devices is None:
            devices = worker_devices(workers)
        elif workers is not None and len(devices) != workers:
            raise ValueError(f"workers={workers} disagrees with "
                             f"{len(devices)} explicit devices")
        self.devices = tuple(devices)
        if not self.devices:
            raise ValueError("need at least one worker device")
        if isinstance(model_or_ckpt, str):
            from repro_torch.checkpoint.manager import restore_model
            model = restore_model(model_or_ckpt, device=self.devices[0])
        elif isinstance(model_or_ckpt, GeekModel):
            model = model_or_ckpt
        else:
            raise TypeError("model_or_ckpt must be a GeekModel or a "
                            "checkpoint directory, got "
                            f"{type(model_or_ckpt).__name__}")
        self.name = name
        self.max_batch = int(max_batch)
        self.registry = registry if registry is not None else ModelRegistry()
        if name not in self.registry.names():
            self.registry.publish(name, model)
        # every ClusterServer finds the name published and serves the
        # same initial version
        self.servers = tuple(
            ClusterServer(model, probes=probes, max_batch=max_batch,
                          deadline_ms=deadline_ms, min_bucket=min_bucket,
                          ladder=ladder, registry=self.registry, name=name,
                          device=dev)
            for dev in self.devices)
        self._lock = threading.Lock()
        self._queued = [0] * len(self.servers)
        self._last = 0
        self._sticky = 0
        self._spills = 0
        self._closed = False

    # -- routing -------------------------------------------------------------

    def _route(self, n: int) -> int:
        """Pick a worker for an ``n``-row request; charge it the rows."""
        with self._lock:
            i = self._last
            if self._queued[i] + n > self.max_batch:
                # overflow: spill to the least-queued worker, stick there
                i = min(range(len(self._queued)),
                        key=self._queued.__getitem__)
                self._last = i
                self._spills += 1
            else:
                self._sticky += 1
            self._queued[i] += n
            return i

    def _uncharge(self, i: int, n: int) -> None:
        with self._lock:
            self._queued[i] -= n

    # -- public surface (mirrors ClusterServer) ------------------------------

    @property
    def model(self) -> GeekModel:
        """The model the next micro-batch (on any worker) is served by."""
        return self.registry.current(self.name).model

    @property
    def version(self) -> int:
        """Registry version of :attr:`model`."""
        return self.registry.current(self.name).version

    def submit(self, parts) -> Future:
        """Route one request to a worker; returns its Assignment future
        (``ClusterServer.submit``'s payload contract)."""
        if self._closed:
            raise ServerClosedError("pool is closed")
        if not isinstance(parts, (tuple, list)):
            parts = (parts,)
        parts = tuple(None if p is None else _host_array(p) for p in parts)
        try:
            n = next(int(p.shape[0]) for p in parts if p is not None)
        except StopIteration:
            raise ValueError("all query parts are None") from None
        i = self._route(n)
        try:
            fut = self.servers[i].submit(parts)
        except BaseException:
            self._uncharge(i, n)
            raise
        fut.add_done_callback(lambda _f: self._uncharge(i, n))
        return fut

    def swap(self, model_or_ckpt, *, step: int | None = None) -> int:
        """Publish a new version ONCE for the whole pool; returns it."""
        if isinstance(model_or_ckpt, str):
            return self.registry.load(self.name, model_or_ckpt, step=step,
                                      device=self.devices[0])
        _written(model_or_ckpt)
        return self.registry.publish(self.name, model_or_ckpt)

    def warmup(self, parts) -> None:
        """Walk every worker's pad ladder."""
        for s in self.servers:
            s.warmup(parts)

    def stats(self) -> dict:
        """Aggregated counters + per-worker snapshots + routing stats."""
        per_worker = [s.stats() for s in self.servers]
        agg: dict = {"submitted": 0, "completed": 0, "failed": 0,
                     "batches": 0, "rows_served": 0, "padded_rows": 0}
        for st in per_worker:
            for k in agg:
                agg[k] += st[k]
        with self._lock:
            agg["routing"] = {"sticky": self._sticky,
                              "spills": self._spills,
                              "queued_rows": list(self._queued)}
        agg["workers"] = per_worker
        return agg

    def close(self, timeout: float | None = 30.0) -> None:
        """Close every worker (each drains its own queue)."""
        self._closed = True
        for s in self.servers:
            s.close(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __len__(self) -> int:
        """Worker count."""
        return len(self.servers)
