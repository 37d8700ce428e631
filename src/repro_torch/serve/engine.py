"""Async micro-batched serving engine.

The counterpart of ``repro.serve.engine``: a request loop around three
ideas.

1. **Micro-batching.** Callers ``submit()`` single rows or small batches;
   a worker thread accumulates them and flushes a micro-batch when
   ``max_batch`` rows are queued or the OLDEST queued request has waited
   ``deadline_ms``, whichever comes first (max-batch wins when both
   hold).

2. **A pad ladder.** Every micro-batch is cyclically padded up to a small
   ladder of bucket shapes (powers of two plus 1.5x mid-rungs, up to
   ``max_batch``), so the serve step sees a bounded set of shapes. The
   reference compiles one XLA program a rung; here the steps are plain
   functions over the port's kernels (``predict(model, model.encode(*parts))``
   and ``predict_probed``), whose shapes stay static per rung. A CUDA
   graph per rung is not captured.

3. **Double-buffered dispatch.** Batch N+1's host→device copy and its
   launches are issued before batch N's results are read back. On the
   card a padded batch crosses through pinned staging buffers, two in
   flight, on a copy stream of their own (``core.streaming._Stager``,
   guarded by CUDA events); its labels and distances are copied back
   into pinned buffers right after its launches, and ``_retire`` waits on
   that copy's event alone, not on the batch after it. (A ``non_blocking``
   copy from pageable numpy memory would be synchronous.) XLA's buffer
   donation has no counterpart and is not emulated: the staging buffers
   are allocated once and reused.

Each server owns one device (``device=``: a card, default ``cuda``, or
``"cpu"``); its worker thread enters that device and launches on a
stream of its own, so two servers on one card (``WorkerPool``) keep
their work apart. Hot-swap rides the ``ModelRegistry``: the worker
snapshots the registry's current model once per micro-batch, so
``swap()`` is atomic between micro-batches. Exact (``probes=None``),
probed (``probes=p``: center-index candidates, empty-probe rows patched
with the exact scan at retire time) and sharded (``mesh=``) serving ride
this one loop; labels are the direct ``predict`` paths' bit for bit.

``mesh=`` is a ``utils.compat.Mesh`` over a ``torch.distributed``
process group, one process a rank. A deadline that each rank judged
alone would desynchronize the collectives of the sharded step, so rank 0
leads: requests are submitted there (``submit`` elsewhere raises
``NotLeaderError``), its worker decides each flush and broadcasts the
padded rows and the model version, and every other rank's
``ClusterServer(..., mesh=)`` runs a follower loop that calls the same
sharded step (``make_predict_sharded``). ``close()`` on rank 0 ends the
followers; ``close()`` on a follower waits for that. ``swap`` must be
called on every rank, in the same order.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from repro_torch.core.model import (GeekModel, patch_probed_fallback, predict,
                                    predict_probed)
from repro_torch.serve.registry import ModelRegistry, _transform_kind
from repro_torch.utils.device import (full_precision_matmul, indexed,
                                      parts_to_device, tree_to)

#: queue sentinel shutting the worker down
_CLOSE = object()

#: expected request arity per transform kind: ``(x,)`` dense,
#: ``(x_num, x_cat)`` hetero, ``(sets, mask)`` sparse
_KIND_ARITY = {"identity": 1, "hetero": 2, "sparse": 2}

#: how long a follower waits for a swap the leader already serves
_FOLLOW_SWAP_S = 60.0


class ServerClosedError(RuntimeError):
    """``submit()`` after ``close()``: the worker is gone for good.

    Named so callers (and the HTTP front end, which maps it to a 503) can
    tell a deliberate shutdown from the plain ``RuntimeError`` a dead
    worker raises. Raised at submit time: a request is never enqueued
    onto a dead worker, where its future would hang.
    """


class NotLeaderError(RuntimeError):
    """``submit()`` on a rank other than 0 of a ``mesh=`` server: rank 0
    decides every flush, the other ranks follow."""


# ---------------------------------------------------------------------------
# The serve steps
# ---------------------------------------------------------------------------

def _exact_step(model: GeekModel, parts: tuple):
    """Fit-time coding (``model.encode``) + the one-pass assignment: on
    the card the assignment kernel of the model's metric."""
    return predict(model, model.encode(*parts))


def _probed_step(model: GeekModel, parts: tuple, probes: int):
    """Coding + center-index assignment: the raw ``(labels, dists,
    empty)`` triple, patched at retire time."""
    return predict_probed(model, model.encode(*parts), probes)


def pad_ladder(max_batch: int, *, min_bucket: int = 64,
               multiple: int = 1) -> tuple[int, ...]:
    """The bucket shapes micro-batches are padded to.

    Powers of two from ``min_bucket`` up to (and always including)
    ``max_batch``, plus the 1.5x midpoint between each pair, all rounded
    up to ``multiple`` (the mesh size for sharded serving, so the sharded
    step never re-pads). The mid-rungs cap padding waste at a third of a
    bucket.

    Parameters
    ----------
    max_batch : int
        The engine's flush threshold: the top rung.
    min_bucket : int
        Smallest bucket (single-row requests pad to this).
    multiple : int
        Round every rung up to this multiple (>= 1).

    Returns
    -------
    tuple of int
        Strictly increasing bucket sizes; the last is >= ``max_batch``.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    mult = max(int(multiple), 1)

    def up(v):
        return -(-v // mult) * mult

    rungs, b = set(), max(1, min(min_bucket, max_batch))
    while b < max_batch:
        rungs.add(up(b))
        if b + b // 2 < max_batch:
            rungs.add(up(b + b // 2))
        b <<= 1
    rungs.add(up(max_batch))
    return tuple(sorted(rungs))


def bucket_for(n: int, ladder: tuple[int, ...]) -> int:
    """The smallest ladder rung holding ``n`` rows."""
    i = bisect.bisect_left(ladder, n)
    if i == len(ladder):
        raise ValueError(f"batch of {n} rows exceeds the ladder top "
                         f"{ladder[-1]}")
    return ladder[i]


@dataclasses.dataclass(frozen=True)
class Assignment:
    """One resolved request: labels and dists plus serving provenance.

    Attributes
    ----------
    labels : (n,) np.ndarray int32
        Cluster assignments, the direct ``predict`` path's bit for bit.
    dists : (n,) np.ndarray float32
        Distances, as ``GeekResult``'s.
    version : int
        Registry version of the model that served this request (and its
        whole micro-batch).
    """

    labels: np.ndarray
    dists: np.ndarray
    version: int


class _Request:
    """A queued submit: host-side parts + the future to resolve."""

    __slots__ = ("parts", "n", "future", "t_submit")

    def __init__(self, parts, n, future, t_submit):
        self.parts = parts
        self.n = n
        self.future = future
        self.t_submit = t_submit


def _signature(parts: tuple) -> tuple:
    """Widths and dtypes of a batch's parts (None kept): what the staging
    buffers are allocated for."""
    return tuple(None if p is None else (p.shape[1:], p.dtype) for p in parts)


class _Staging:
    """The card's double buffer for one part signature: the inputs'
    pinned and device slots (``core.streaming._Stager``) and two slots of
    pinned result buffers, each with the event of its copy back."""

    def __init__(self, like: tuple, rows: int, device: torch.device,
                 out_dtypes: tuple):
        from repro_torch.core.streaming import _Stager
        self.signature = _signature(like)
        self.stager = _Stager(like, rows, device)
        self.out = [[torch.empty((rows,), dtype=dt, pin_memory=True)
                     for dt in out_dtypes] for _ in range(2)]
        self.ready = [torch.cuda.Event() for _ in range(2)]


# header of a broadcast micro-batch: [op, rows, real rows, version] then
# (present, width, dtype code) a part
_OP_BATCH, _OP_END = 1, 2
_WIRE = (torch.float32, torch.int32, torch.bool)


class ClusterServer:
    """Micro-batched async assignment server over a fitted GeekModel.

    Parameters
    ----------
    model_or_ckpt : GeekModel or str
        The model to serve, or a checkpoint directory to restore it from
        (``repro_torch.checkpoint.manager.restore_model``, on the
        server's device).
    probes : int or None
        ``None``: exact serving. ``p >= 0``: probe the model's center
        index; empty-probe rows are patched with the exact scan at retire
        time, exactly like ``predict(probes=p)``.
    mesh : utils.compat.Mesh or None
        Row-shard every micro-batch over the ranks of this mesh
        (``make_predict_sharded``, composes with ``probes``). Construct
        the server on every rank; rank 0 leads (module docstring). The
        device follows the mesh's backend (NCCL: the current card; gloo:
        the CPU).
    max_batch : int
        Flush threshold: a micro-batch dispatches as soon as this many
        rows are queued.
    deadline_ms : float
        Flush deadline: a micro-batch dispatches once the oldest queued
        request has waited this long, full or not.
    mesh_axis : str
        Mesh axis name for sharded serving.
    min_bucket : int
        Bottom rung of the pad ladder.
    ladder : tuple of int or None
        Explicit pad-ladder override (strictly increasing rungs whose top
        covers ``max_batch``; every rung a multiple of the mesh size).
    registry : ModelRegistry or None
        Shared registry for multi-model deployments; by default the
        server owns a private one.
    name : str
        Registry name this server serves (and ``swap`` publishes to).
    device : str or torch.device or None
        The device every micro-batch runs on and the model is copied to
        (once a registry record): ``None`` is ``cuda`` and raises when
        there is no card; ``"cpu"`` serves on the plain path. Mutually
        exclusive with ``mesh``.

    Notes
    -----
    ``submit(parts)`` returns a ``concurrent.futures.Future`` resolving
    to an :class:`Assignment`. Requests never span micro-batches and a
    micro-batch is served by exactly one model version, so a ``swap()``
    mid-stream is atomic: no dropped requests, no mixed batches.

    Failure contract: a serve step that raises resolves exactly that
    micro-batch's futures with the exception and the worker keeps
    serving; an error that kills the worker resolves EVERY outstanding
    future with it and makes further ``submit`` calls raise; ``submit``
    after ``close`` raises ``ServerClosedError``. Futures always resolve.
    """

    def __init__(self, model_or_ckpt, *, probes: int | None = None,
                 mesh=None, max_batch: int = 4096,
                 deadline_ms: float = 5.0, mesh_axis: str = "data",
                 min_bucket: int = 64,
                 ladder: tuple[int, ...] | None = None,
                 registry: ModelRegistry | None = None,
                 name: str = "default", device=None):
        if device is not None and mesh is not None:
            raise ValueError("device= pins single-device serving and "
                             "cannot compose with mesh= (sharded serving "
                             "places its own data)")
        if mesh is not None:
            from repro_torch.utils import compat
            device = "cuda" if mesh.backend == "nccl" else "cpu"
            compat.check_device(mesh, torch.device(device), mesh_axis)
        self.device = indexed(device)
        if isinstance(model_or_ckpt, str):
            from repro_torch.checkpoint.manager import restore_model
            model = restore_model(model_or_ckpt, mesh=mesh,
                                  device=self.device)
        elif isinstance(model_or_ckpt, GeekModel):
            model = model_or_ckpt
        else:
            raise TypeError("model_or_ckpt must be a GeekModel or a "
                            f"checkpoint directory, got "
                            f"{type(model_or_ckpt).__name__}")
        if probes is not None:
            probes = int(probes)
            if probes < 0:
                raise ValueError(f"probes must be >= 0, got {probes}")
            if model.index_tables <= 0:
                raise ValueError(
                    "probed serving requested but the model was built "
                    "with index_tables=0 (no center index) — serve with "
                    "probes=None or rebuild the model with an index")
        if deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        self.probes = probes
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.max_batch = int(max_batch)
        self.deadline = float(deadline_ms) / 1e3
        self.name = name
        self._dev_model = None    # (ModelRecord, model on self.device)
        g = mesh.size if mesh is not None else 1
        if ladder is not None:
            rungs = tuple(int(r) for r in ladder)
            if not rungs or rungs[0] < 1 or \
                    any(b <= a for a, b in zip(rungs, rungs[1:])):
                raise ValueError("ladder must be a non-empty strictly "
                                 f"increasing tuple of positive ints, got "
                                 f"{rungs}")
            if rungs[-1] < self.max_batch:
                raise ValueError(f"ladder top rung {rungs[-1]} does not "
                                 f"cover max_batch={self.max_batch}")
            if any(r % g for r in rungs):
                raise ValueError(f"every ladder rung must be a multiple of "
                                 f"the mesh size {g}, got {rungs}")
            self.ladder = rungs
        else:
            self.ladder = pad_ladder(self.max_batch, min_bucket=min_bucket,
                                     multiple=g)
        full_precision_matmul()
        _written(model)
        self.registry = registry if registry is not None else ModelRegistry()
        if name not in self.registry.names():
            self.registry.publish(name, model)
        self._arity = _KIND_ARITY[_transform_kind(model)]
        self._leader = mesh is None or mesh.rank == 0
        if mesh is not None:
            from repro_torch.core.distributed import make_predict_sharded
            self._sharded_fn = make_predict_sharded(mesh, axis=mesh_axis,
                                                    probes=probes)
        on_card = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if on_card else None
        self._staging: _Staging | None = None
        self._seq = 0
        self._queue: queue.Queue = queue.Queue()
        self._inflight = None
        self._pending: list[_Request] = []   # worker-owned accumulation
        self._fatal: BaseException | None = None
        self._closed = False
        self._stats_lock = threading.Lock()
        self._stats = {"submitted": 0, "completed": 0, "failed": 0,
                       "batches": 0, "rows_served": 0, "padded_rows": 0,
                       "flushes": {"max_batch": 0, "deadline": 0,
                                   "close": 0},
                       "swaps": 0}
        self._worker = threading.Thread(
            target=self._run if self._leader else self._follow_run,
            daemon=True, name="repro-torch-serve-worker")
        self._worker.start()

    # -- public surface ------------------------------------------------------

    @property
    def model(self) -> GeekModel:
        """The model the NEXT micro-batch will be served by."""
        return self.registry.current(self.name).model

    @property
    def version(self) -> int:
        """Registry version of :attr:`model`."""
        return self.registry.current(self.name).version

    def submit(self, parts) -> Future:
        """Enqueue one request; returns a future of :class:`Assignment`.

        Parameters
        ----------
        parts : array or tuple of arrays
            Raw query parts of the model's kind, on the host: ``x`` /
            ``(x,)`` dense, ``(x_num, x_cat)`` hetero (either may be None
            as fitted), ``(sets, mask)`` sparse. 1 to ``max_batch`` rows;
            chunk bigger payloads into several submits.
        """
        if not self._leader:
            raise NotLeaderError(
                f"submit() on rank {self.mesh.rank}: a mesh server takes "
                "requests on rank 0, which leads every flush")
        if self._closed:
            raise ServerClosedError(
                "server is closed — submit() after close() cannot be "
                "served (stand up a new ClusterServer)")
        if self._fatal is not None:
            raise RuntimeError("serving worker died") from self._fatal
        if not isinstance(parts, (tuple, list)):
            parts = (parts,)
        if len(parts) != self._arity:
            raise ValueError(f"expected {self._arity} query part(s) for "
                             f"this model's kind, got {len(parts)}")
        parts = tuple(None if p is None else _host_array(p) for p in parts)
        ns = {p.shape[0] for p in parts if p is not None}
        if len(ns) != 1:
            raise ValueError("query parts disagree on row count (or are "
                             "all None)")
        n = ns.pop()
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"request of {n} rows outside [1, "
                             f"{self.max_batch}] — split oversized "
                             "payloads into several submits")
        fut: Future = Future()
        with self._stats_lock:
            self._stats["submitted"] += 1
        self._queue.put(_Request(parts, n, fut, time.monotonic()))
        if self._fatal is not None and not fut.done():
            # lost the race with a concurrent worker death: the drain in
            # _fail may have missed this request, so resolve it here
            try:
                fut.set_exception(RuntimeError("serving worker died"))
            except InvalidStateError:
                pass  # _fail got it first
        if self._closed and not fut.done():
            # lost the race with a concurrent close(): this request may
            # sit behind the close sentinel after the worker's last
            # drain, so resolve it here with the named error
            try:
                fut.set_exception(ServerClosedError(
                    "server closed while the request was being submitted"))
            except InvalidStateError:
                pass  # the close drain served it first
        return fut

    def swap(self, model_or_ckpt, *, step: int | None = None) -> int:
        """Publish a new model version; returns its version number.

        Takes effect atomically at the next micro-batch boundary. A model
        of another traffic kind or feature width is refused
        (``ModelRegistry.publish``). A model on the card is synchronized
        before it is published, so no batch reads a tensor still being
        written.
        """
        if isinstance(model_or_ckpt, str):
            version = self.registry.load(self.name, model_or_ckpt,
                                         step=step, mesh=self.mesh,
                                         device=self.device)
        else:
            _written(model_or_ckpt)
            version = self.registry.publish(self.name, model_or_ckpt)
        with self._stats_lock:
            self._stats["swaps"] += 1
        return version

    def warmup(self, parts) -> None:
        """Run every ladder rung once with example traffic (``parts``
        padded cyclically to each rung): the kernels are built and loaded
        before the first request. With ``mesh=`` (on rank 0) the rungs go
        through the worker as requests, so every collective is issued by
        the worker; on a follower this does nothing."""
        if not isinstance(parts, (tuple, list)):
            parts = (parts,)
        parts = tuple(None if p is None else _host_array(p) for p in parts)
        n = next(p.shape[0] for p in parts if p is not None)
        if self.mesh is not None:
            if self._leader:
                for bucket in self.ladder:
                    m = min(bucket, self.max_batch)
                    idx = np.arange(m) % n
                    self.submit(tuple(None if p is None else p[idx]
                                      for p in parts)).result(timeout=600)
            return
        model = self._on_device(self.registry.current(self.name))
        with self._device_scope():
            for bucket in self.ladder:
                idx = np.arange(bucket) % n
                dev = parts_to_device(tuple(None if p is None else p[idx]
                                            for p in parts), self.device)
                out = (_exact_step(model, dev) if self.probes is None else
                       _probed_step(model, dev, self.probes))
                tuple(o.cpu() for o in out)

    def stats(self) -> dict:
        """A snapshot of serving counters (copies; safe to mutate)."""
        with self._stats_lock:
            out = dict(self._stats)
            out["flushes"] = dict(self._stats["flushes"])
            return out

    def close(self, timeout: float | None = 30.0) -> None:
        """Flush queued requests, retire in-flight work, stop the worker.
        On a mesh follower: wait (up to ``timeout``) for rank 0's end."""
        if self._closed:
            return
        self._closed = True
        if self._leader:
            self._queue.put(_CLOSE)
        self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- worker loop ---------------------------------------------------------

    @contextlib.contextmanager
    def _device_scope(self):
        """The server's card and stream, entered by whoever launches."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    def _run(self) -> None:
        """Worker entry: the serve loop behind a fatal-error backstop.

        Per-batch errors are contained by ``_flush`` / ``_retire``.
        Anything that escapes the loop is a worker-killing bug; ``_fail``
        then resolves EVERY outstanding future with the error, and later
        submits raise instead of queueing into a dead loop. A mesh leader
        ends its followers whichever way the loop ends.
        """
        try:
            with self._device_scope():
                try:
                    self._serve_loop()
                finally:
                    if self.mesh is not None:
                        self._broadcast_header(_OP_END, 0, 0, 0, ())
        except BaseException as e:   # noqa: BLE001 — fatal backstop
            self._fail(e)

    def _fail(self, exc: BaseException) -> None:
        """Resolve every outstanding future with ``exc``; poison submit."""
        self._fatal = exc
        doomed = list(self._pending)
        self._pending.clear()
        if self._inflight is not None:
            doomed.extend(self._inflight[0])
            self._inflight = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _CLOSE:
                doomed.append(item)
        for r in doomed:
            try:
                r.future.set_exception(exc)
            except InvalidStateError:
                pass
        with self._stats_lock:
            self._stats["failed"] += len(doomed)

    def _serve_loop(self) -> None:
        pending = self._pending
        rows = sum(r.n for r in pending)
        closing = False
        while not closing:
            # drain everything already queued before deciding to flush:
            # under backlog the oldest deadline is long expired, and a
            # flush after every get() would never coalesce
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is _CLOSE:
                    closing = True
                    break
                pending.append(item)
                rows += item.n
            if pending and rows >= self.max_batch:
                # a full bucket outranks an expired deadline (and the
                # close sentinel): dispatch it at the top rung
                rows = self._flush(pending, rows, "max_batch")
                continue
            if closing:
                continue
            if pending:
                wait = self.deadline - (time.monotonic()
                                        - pending[0].t_submit)
                if wait <= 0:
                    rows = self._flush(pending, rows, "deadline")
                    continue
            else:
                wait = None
                # idle: don't sit on finished work while blocking
                self._retire()
            try:
                item = self._queue.get(timeout=wait)
            except queue.Empty:
                continue
            if item is _CLOSE:
                closing = True
                continue
            pending.append(item)
            rows += item.n
        # drain: anything that raced in behind the close sentinel
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _CLOSE:
                pending.append(item)
                rows += item.n
        while pending:
            rows = self._flush(pending, rows, "close")
        self._retire()

    def _flush(self, pending: list[_Request], rows: int,
               reason: str) -> int:
        """Dispatch one micro-batch from the head of ``pending``.

        Takes the longest request prefix fitting ``max_batch`` (requests
        never split), dispatches it against the registry's CURRENT model
        (the hot-swap atomicity point) and only then retires the previous
        in-flight batch, so batch N+1's copy and launches are queued
        before batch N is read back. Returns the rows still pending.
        """
        take, taken = [], 0
        while pending and taken + pending[0].n <= self.max_batch:
            take.append(pending.pop(0))
            taken += take[-1].n
        if not take:
            return rows
        try:
            # the registry snapshot sits inside the per-batch guard: a
            # failing registry or a poisoned record fails this batch only
            rec = self.registry.current(self.name)
            host = tuple(
                None if take[0].parts[i] is None else
                np.concatenate([r.parts[i] for r in take], axis=0)
                for i in range(self._arity))
            finish = self._dispatch(self._on_device(rec), host, taken,
                                    rec.version)
        except Exception as e:                  # noqa: BLE001 — per-batch
            for r in take:
                r.future.set_exception(e)
            with self._stats_lock:
                self._stats["failed"] += len(take)
            return rows - taken
        self._retire()
        self._inflight = (take, taken, rec, finish)
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["flushes"][reason] += 1
            self._stats["padded_rows"] += bucket_for(taken,
                                                     self.ladder) - taken
        return rows - taken

    def _on_device(self, rec) -> GeekModel:
        """The record's model on the server's device: itself when it is
        there already, else a copy made once a record (the cache is keyed
        by record identity, so a hot-swap refreshes it exactly once)."""
        if rec.model.device == self.device:
            return rec.model
        cached = self._dev_model
        if cached is None or cached[0] is not rec:
            cached = (rec, tree_to(rec.model, self.device))
            self._dev_model = cached
        return cached[1]

    def _dispatch(self, model: GeekModel, host: tuple, n: int,
                  version: int):
        """Pad to the ladder, issue the serve step; returns a
        ``finish() -> (labels, dists)`` callable that waits for it."""
        bucket = bucket_for(n, self.ladder)
        if bucket > n:
            # cyclic pad (always real rows): gather only the tail
            idx = np.arange(bucket - n) % n
            padded = tuple(None if p is None else
                           np.concatenate([p, p[idx]], axis=0)
                           for p in host)
        else:
            padded = host
        if self.mesh is not None:
            dev = parts_to_device(padded, self.device)
            self._broadcast_batch(dev, n, version)
            lab, dst = self._sharded_fn(model, *dev)
            return lambda: (lab[:n].cpu().numpy(), dst[:n].cpu().numpy())
        fetch = self._launch(model, padded, bucket, n)
        if self.probes is None:
            return fetch

        def finish():
            """Probed retire: real rows, empty probes patched exact."""
            lab, dst, emp = fetch()
            labels, dists = patch_probed_fallback(
                torch.from_numpy(lab), torch.from_numpy(dst),
                torch.from_numpy(emp),
                lambda ix: self._exact_rows(model, host, ix))
            return labels.numpy(), dists.numpy()

        return finish

    def _launch(self, model: GeekModel, padded: tuple, bucket: int, n: int):
        """Issue one padded batch's copy in, its step and its copy back;
        returns ``fetch() -> outputs[:n]`` as host arrays."""
        step = ((lambda dev: _exact_step(model, dev)) if self.probes is None
                else (lambda dev: _probed_step(model, dev, self.probes)))
        if self._stream is None:
            out = step(parts_to_device(padded, self.device))
            return lambda: tuple(o[:n].numpy() for o in out)
        st = self._staging
        if st is None or st.signature != _signature(padded):
            dtypes = (torch.int32, torch.float32) + (
                () if self.probes is None else (torch.bool,))
            st = self._staging = _Staging(padded, self.ladder[-1],
                                          self.device, dtypes)
        i, self._seq = self._seq, self._seq + 1
        s = i % 2
        out = step(st.stager.put(i, padded))
        st.stager.done(i)
        for h, o in zip(st.out[s], out):
            h[:bucket].copy_(o, non_blocking=True)
        st.ready[s].record()

        def fetch():
            st.ready[s].synchronize()
            return tuple(h[:n].numpy().copy() for h in st.out[s])

        return fetch

    def _exact_rows(self, model: GeekModel, host: tuple, ix: torch.Tensor):
        """The exact step on rows ``ix`` of the batch (host tensors out):
        the probed path's fallback."""
        rows = tuple(None if p is None else p[ix.numpy()] for p in host)
        lab, dst = _exact_step(model, parts_to_device(rows, self.device))
        return lab.cpu(), dst.cpu()

    def _retire(self) -> None:
        """Resolve the previous micro-batch's futures (waits for it)."""
        if self._inflight is None:
            return
        take, taken, rec, finish = self._inflight
        self._inflight = None
        try:
            labels, dists = finish()
        except Exception as e:                  # noqa: BLE001 — per-batch
            for r in take:
                r.future.set_exception(e)
            with self._stats_lock:
                self._stats["failed"] += len(take)
            return
        off = 0
        for r in take:
            try:
                r.future.set_result(Assignment(labels[off:off + r.n],
                                               dists[off:off + r.n],
                                               rec.version))
            except InvalidStateError:
                pass  # a submit/close race already failed this future
            off += r.n
        with self._stats_lock:
            self._stats["completed"] += len(take)
            self._stats["rows_served"] += taken

    # -- mesh: the leader's broadcasts and the followers' loop ---------------

    def _src(self) -> int:
        import torch.distributed as dist
        group = self.mesh.group
        return 0 if group is None else dist.get_global_rank(group, 0)

    def _broadcast_header(self, op: int, rows: int, n: int, version: int,
                          parts: tuple) -> None:
        import torch.distributed as dist
        head = [op, rows, n, version]
        for i in range(self._arity):
            p = parts[i] if i < len(parts) else None
            head += ([0, 0, 0] if p is None else
                     [1, p.shape[1], _WIRE.index(p.dtype)])
        t = torch.tensor(head, dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=self._src(), group=self.mesh.group)

    def _broadcast_batch(self, dev: tuple, n: int, version: int) -> None:
        """Rank 0: send the padded batch and its version to the followers."""
        import torch.distributed as dist
        rows = next(p.shape[0] for p in dev if p is not None)
        self._broadcast_header(_OP_BATCH, rows, n, version, dev)
        for p in dev:
            if p is not None:
                wire = p.to(torch.uint8) if p.dtype == torch.bool else p
                dist.broadcast(wire.contiguous(), src=self._src(),
                               group=self.mesh.group)

    def _follow_run(self) -> None:
        try:
            with self._device_scope():
                self._follow()
        except BaseException as e:   # noqa: BLE001 — fatal backstop
            self._fatal = e

    def _follow(self) -> None:
        """A follower rank: receive each batch rank 0 flushes and run the
        same sharded step on it, until rank 0 ends."""
        import torch.distributed as dist
        width = 4 + 3 * self._arity
        while True:
            head = torch.empty((width,), dtype=torch.int64,
                               device=self.device)
            dist.broadcast(head, src=self._src(), group=self.mesh.group)
            h = head.tolist()
            if h[0] == _OP_END:
                return
            rows, version = h[1], h[3]
            parts = []
            for i in range(self._arity):
                present, w, code = h[4 + 3 * i:7 + 3 * i]
                if not present:
                    parts.append(None)
                    continue
                dt = _WIRE[code]
                t = torch.empty((rows, w), device=self.device,
                                dtype=torch.uint8 if dt == torch.bool else dt)
                dist.broadcast(t, src=self._src(), group=self.mesh.group)
                parts.append(t.to(dt))
            rec = self._record(version)
            self._sharded_fn(self._on_device(rec), *parts)

    def _record(self, version: int):
        """The registry record of ``version``, waiting for a swap the
        leader already serves (every rank swaps in the same order)."""
        deadline = time.monotonic() + _FOLLOW_SWAP_S
        while True:
            try:
                return self.registry.get(self.name, version)
            except KeyError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.001)


def _host_array(p) -> np.ndarray:
    """A request part as a host numpy array (a tensor is copied back)."""
    if isinstance(p, torch.Tensor):
        return p.detach().cpu().numpy()
    return np.asarray(p)


def _written(model: GeekModel) -> None:
    """Wait until a model on the card is written (the stream that made
    it is unknown here, so the whole device)."""
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
