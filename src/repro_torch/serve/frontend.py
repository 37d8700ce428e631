"""Dependency-free HTTP front end over the serving tier.

The counterpart of ``repro.serve.frontend``, with the same routes, status
codes, error names and JSON payloads, over the port's engine: one
``ClusterFrontend`` wraps anything with the ``submit/swap/stats/close``
surface (a ``ClusterServer`` or a ``WorkerPool``) in the standard
library's ``http.server.ThreadingHTTPServer`` and exposes:

- ``POST /v1/assign``: rows in, ``labels`` / ``dists`` / ``version`` out.
  Bodies are JSON (``{"rows": [[...]]}`` dense, ``{"parts": [p0, p1]}``
  any kind) or raw float32 (``Content-Type: application/octet-stream``,
  row-major ``n x d``, dense models only); responses are JSON, or raw
  (int32 labels ++ float32 dists) under ``Accept:
  application/octet-stream``. A per-request deadline (``deadline_ms``
  field / ``X-Deadline-Ms`` header) bounds the wait on the engine's
  future: 504 on expiry.
- ``GET /v1/stats``: engine counters + model provenance.
- ``GET /healthz``: liveness (200 ``ok`` while serving).
- ``POST /v1/swap``: ``{"ckpt": dir}`` publishes a checkpoint; returns
  the new version.

Every non-200 body is ``{"error": "<Name>", "detail": "..."}``: 4xx for
caller mistakes (``ArityMismatch`` / ``WidthMismatch`` / ``KindMismatch``
/ ``TooManyRows`` / ``BadRequest``), 404 ``CheckpointNotFound``, 503
``ServerClosed`` (and ``ServiceUnavailable`` for a dead worker, or a
mesh follower, which takes no requests), 504 ``DeadlineExceeded``, 500
``AssignFailed`` when the engine failed the batch. Width and kind are
checked before submit, so a malformed request never poisons a
micro-batch.

An ``observer`` callable (the autopilot's ``observe``) sees every
successfully parsed assign payload: served traffic feeds the refit
reservoir without a second ingest path.
"""
from __future__ import annotations

import json
import threading
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.serve.engine import (_KIND_ARITY, NotLeaderError,
                                      ServerClosedError)
from repro_torch.serve.registry import _transform_kind

#: default wait on the engine future when the request carries no deadline
DEFAULT_DEADLINE_S = 30.0


class FrontendError(Exception):
    """An HTTP-mappable request failure (named error + status code)."""

    def __init__(self, status: int, name: str, detail: str):
        super().__init__(detail)
        self.status = status
        self.name = name
        self.detail = detail


def _parse_assign(body: bytes, content_type: str, kind: str, arity: int,
                  d: int, max_batch: int) -> tuple[tuple, float | None]:
    """Decode an assign payload into engine parts; raise named 4xx.

    Returns ``(parts, deadline_ms_or_None)``. Raw float32 bodies are
    only meaningful for dense (identity-transform) models — the row
    width is the model's ``d`` and anything else is a ``KindMismatch``.
    """
    deadline_ms = None
    if content_type.startswith("application/octet-stream"):
        if kind != "identity":
            raise FrontendError(
                400, "KindMismatch",
                f"raw float32 bodies serve dense models only; this model "
                f"codes {kind!r} traffic — POST JSON parts instead")
        if len(body) == 0 or len(body) % (4 * d) != 0:
            raise FrontendError(
                400, "WidthMismatch",
                f"raw body of {len(body)} bytes is not a whole number of "
                f"float32 rows of width d={d}")
        rows = np.frombuffer(body, dtype="<f4").reshape(-1, d)
        parts: tuple = (rows,)
    else:
        try:
            payload = json.loads(body)
        except (ValueError, UnicodeDecodeError) as e:
            raise FrontendError(400, "BadRequest",
                                f"body is not valid JSON: {e}") from None
        if not isinstance(payload, dict):
            raise FrontendError(400, "BadRequest",
                                "JSON body must be an object")
        deadline_ms = payload.get("deadline_ms")
        if deadline_ms is not None and (
                not isinstance(deadline_ms, (int, float))
                or deadline_ms <= 0):
            raise FrontendError(400, "BadRequest",
                                f"deadline_ms must be a positive number, "
                                f"got {deadline_ms!r}")
        if "rows" in payload:
            raw_parts = [payload["rows"]]
        elif "parts" in payload:
            if not isinstance(payload["parts"], list):
                raise FrontendError(400, "BadRequest",
                                    '"parts" must be a list of arrays')
            raw_parts = payload["parts"]
        else:
            raise FrontendError(400, "BadRequest",
                                'JSON body needs "rows" (dense) or '
                                '"parts" (any kind)')
        if len(raw_parts) != arity:
            raise FrontendError(
                400, "ArityMismatch",
                f"this model's kind ({kind!r}) takes {arity} query "
                f"part(s), got {len(raw_parts)}")
        try:
            parts = tuple(None if p is None else np.asarray(p)
                          for p in raw_parts)
        except (ValueError, TypeError) as e:
            raise FrontendError(400, "BadRequest",
                                f"parts are not rectangular arrays: {e}") \
                from None
    ns = set()
    for p in parts:
        if p is None:
            continue
        if p.ndim != 2:
            raise FrontendError(400, "BadRequest",
                                f"each part must be 2-D (rows x features), "
                                f"got shape {p.shape}")
        ns.add(int(p.shape[0]))
    if len(ns) != 1:
        raise FrontendError(400, "BadRequest",
                            f"query parts disagree on row count: {ns}")
    n = ns.pop()
    if kind == "identity" and parts[0].shape[1] != d:
        raise FrontendError(
            400, "WidthMismatch",
            f"model codes d={d} features, request rows have width "
            f"{parts[0].shape[1]}")
    if n > max_batch:
        raise FrontendError(
            413, "TooManyRows",
            f"request of {n} rows exceeds max_batch={max_batch} — split "
            "the payload into several requests")
    return parts, deadline_ms


class _Handler(BaseHTTPRequestHandler):
    """Per-connection handler; ``frontend`` is injected by subclassing."""

    frontend: "ClusterFrontend"
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # noqa: D102 — silence stderr spam
        pass

    def _send(self, status: int, body: bytes,
              content_type: str = "application/json",
              headers: dict | None = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, obj: dict,
                   headers: dict | None = None) -> None:
        self._send(status, json.dumps(obj).encode(), headers=headers)

    def _send_error(self, e: FrontendError) -> None:
        self.frontend._count(f"http_{e.status}")
        self._send_json(e.status, {"error": e.name, "detail": e.detail})

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    # -- routes --------------------------------------------------------------

    def do_GET(self):  # noqa: N802 — http.server API
        """``/healthz`` and ``/v1/stats``."""
        try:
            if self.path == "/healthz":
                self._send(200, b"ok", content_type="text/plain")
            elif self.path == "/v1/stats":
                self._send_json(200, self.frontend._stats_payload())
            else:
                raise FrontendError(404, "NotFound",
                                    f"unknown path {self.path!r}")
        except FrontendError as e:
            self._send_error(e)

    def do_POST(self):  # noqa: N802 — http.server API
        """``/v1/assign`` and ``/v1/swap``."""
        try:
            if self.path == "/v1/assign":
                self._assign()
            elif self.path == "/v1/swap":
                self._swap()
            else:
                raise FrontendError(404, "NotFound",
                                    f"unknown path {self.path!r}")
        except FrontendError as e:
            self._send_error(e)

    # -- endpoint bodies -----------------------------------------------------

    def _assign(self) -> None:
        fe = self.frontend
        body = self._read_body()
        parts, deadline_ms = _parse_assign(
            body, self.headers.get("Content-Type", "application/json"),
            fe.kind, fe.arity, fe.d, fe.server.max_batch)
        if deadline_ms is None:
            hdr = self.headers.get("X-Deadline-Ms")
            if hdr is not None:
                try:
                    deadline_ms = float(hdr)
                except ValueError:
                    raise FrontendError(
                        400, "BadRequest",
                        f"X-Deadline-Ms is not a number: {hdr!r}") from None
                if deadline_ms <= 0:
                    raise FrontendError(400, "BadRequest",
                                        "X-Deadline-Ms must be > 0")
        fe._observe(parts)
        try:
            fut = fe.server.submit(parts)
        except ServerClosedError as e:
            raise FrontendError(503, "ServerClosed", str(e)) from None
        except NotLeaderError as e:
            raise FrontendError(503, "ServiceUnavailable", str(e)) from None
        except ValueError as e:
            # anything the door checks above could not know (e.g. a
            # hetero part width) still surfaces as a named 400
            raise FrontendError(400, "BadRequest", str(e)) from None
        except RuntimeError as e:
            raise FrontendError(503, "ServiceUnavailable", str(e)) from None
        timeout = (deadline_ms / 1e3 if deadline_ms is not None
                   else fe.default_deadline_s)
        try:
            got = fut.result(timeout=timeout)
        except FutureTimeoutError:
            raise FrontendError(
                504, "DeadlineExceeded",
                f"request deadline of {timeout * 1e3:.0f}ms expired before "
                "the micro-batch resolved") from None
        except Exception as e:  # noqa: BLE001 — engine failed the batch
            raise FrontendError(500, "AssignFailed",
                                f"{type(e).__name__}: {e}") from None
        fe._count("assigned_rows", got.labels.shape[0])
        if "application/octet-stream" in self.headers.get("Accept", ""):
            raw = (np.ascontiguousarray(got.labels, "<i4").tobytes()
                   + np.ascontiguousarray(got.dists, "<f4").tobytes())
            self._send(200, raw, content_type="application/octet-stream",
                       headers={"X-Model-Version": str(got.version),
                                "X-Rows": str(got.labels.shape[0])})
        else:
            self._send_json(200, {"labels": got.labels.tolist(),
                                  "dists": [float(v) for v in got.dists],
                                  "version": got.version})

    def _swap(self) -> None:
        fe = self.frontend
        try:
            payload = json.loads(self._read_body() or b"{}")
        except ValueError as e:
            raise FrontendError(400, "BadRequest",
                                f"body is not valid JSON: {e}") from None
        ckpt = payload.get("ckpt")
        if not isinstance(ckpt, str) or not ckpt:
            raise FrontendError(400, "BadRequest",
                                '"ckpt" (checkpoint directory) is required')
        try:
            version = fe.server.swap(ckpt, step=payload.get("step"))
        except FileNotFoundError as e:
            raise FrontendError(404, "CheckpointNotFound", str(e)) from None
        except ValueError as e:
            name = ("KindMismatch" if "kind mismatch" in str(e)
                    else "WidthMismatch" if "width mismatch" in str(e)
                    else "BadRequest")
            raise FrontendError(400, name, str(e)) from None
        fe._count("swaps")
        self._send_json(200, {"version": version})


class ClusterFrontend:
    """The HTTP face of a ClusterServer or WorkerPool.

    Parameters
    ----------
    server : ClusterServer or WorkerPool
        The engine behind the socket (anything with the
        ``submit/swap/stats/model/version/max_batch`` surface).
    host : str
        Bind address (default loopback; bind ``0.0.0.0`` to expose).
    port : int
        Bind port; 0 picks a free one (read it back from ``address``).
    default_deadline_s : float
        Engine-future wait for requests that carry no deadline.
    observer : callable or None
        Called with every successfully parsed assign payload's parts
        (the autopilot's ``observe`` — served traffic feeds the refit
        reservoir with no second ingest path).

    Notes
    -----
    ``start()`` serves from a daemon thread and returns self;
    ``close()`` stops accepting, finishes in-flight handlers, and
    leaves the underlying engine running (the frontend does not own
    it). Context-manager use starts/closes around the block.
    """

    def __init__(self, server, *, host: str = "127.0.0.1", port: int = 0,
                 default_deadline_s: float = DEFAULT_DEADLINE_S,
                 observer=None):
        self.server = server
        self.default_deadline_s = float(default_deadline_s)
        self.observer = observer
        model = server.model
        self.kind = _transform_kind(model)
        self.arity = _KIND_ARITY[self.kind]
        self.d = int(model.d)
        handler = type("_BoundHandler", (_Handler,), {"frontend": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {"requests": 0}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ClusterFrontend":
        """Serve from a daemon thread; returns self (chainable)."""
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True,
                                        name="repro-torch-serve-http")
        self._thread.start()
        return self

    @property
    def address(self) -> tuple[str, int]:
        """The bound ``(host, port)`` — port resolved when 0 was asked."""
        return self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        """Base URL for clients (``http://host:port``)."""
        host, port = self.address
        return f"http://{host}:{port}"

    def close(self) -> None:
        """Stop accepting, join the serve thread, release the socket."""
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=10)
            self._thread = None
        self.httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- internals used by the handler ---------------------------------------

    def _count(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def _observe(self, parts: tuple) -> None:
        self._count("requests")
        if self.observer is not None:
            try:
                self.observer(parts)
            except Exception:   # noqa: BLE001 — observers must never 500
                self._count("observer_errors")

    def _stats_payload(self) -> dict:
        model = self.server.model
        with self._lock:
            http = dict(self._counters)
        return {
            "engine": self.server.stats(),
            "http": http,
            "version": self.server.version,
            "model": {"kind": self.kind, "d": self.d,
                      "k_star": int(model.k_star),
                      "metric": model.metric},
        }
