"""``ClusterFrontend`` (``repro_torch.serve.frontend``) against
``repro.serve.frontend``, on loopback sockets and the CPU.

Two front ends stand side by side: the reference's over its
``ClusterServer`` and a model fitted by ``repro``, and the port's over its
``ClusterServer(device="cpu")`` and the same model restored from the
reference's checkpoint. The same HTTP requests go to both:

- every status code and every error name are the reference's, the
  malformed requests included (bad JSON, unknown paths, arity, width,
  kind, too many rows, bad deadlines, a missing checkpoint);
- a successful assign carries the reference's labels (dense: equal but at
  near-ties, counted and named) and version, in JSON and in raw float32;
- ``/healthz``, ``/v1/stats`` and ``/v1/swap`` answer with the reference's
  payload keys;
- the deadline, closed-engine and failed-batch mappings (504, 503, 500)
  over a stand-in server, and the observer, which never breaks serving.

Every socket wait has a timeout.
"""
import json
import socket
import types
import urllib.error
import urllib.request
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

import repro_torch as rt
from _torch_parity import assert_labels_match
from repro.checkpoint import manager as jmgr
from repro.core.api import GEEK as JGEEK
from repro.core.api import DenseData as JDense
from repro.core.geek import GeekConfig as JConfig
from repro.serve import ClusterFrontend as JFrontend
from repro.serve import ClusterServer as JServer
from repro_torch.serve import ClusterFrontend, ClusterServer
from repro_torch.serve.engine import NotLeaderError, ServerClosedError
from repro_torch.serve.frontend import FrontendError, _parse_assign

torch.set_num_threads(1)

CFG_KW = dict(m=8, t=16, silk_l=3, delta=3, k_max=32, pair_cap=4096)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(reference front end, port front end, jax model, rows, ckpt dir)."""
    from repro.data import synthetic
    d = synthetic.dense_blobs(jax.random.PRNGKey(0), n=600, d=16, k=8)
    jmodel = JGEEK(JConfig(**CFG_KW)).fit(JDense(d.x), jax.random.PRNGKey(1))
    ckpt = str(tmp_path_factory.mktemp("frontend_ckpt"))
    jmgr.save_model(ckpt, jmodel)
    tmodel = rt.restore_model(ckpt, device="cpu")
    kw = dict(max_batch=64, deadline_ms=2.0, min_bucket=16)
    with JServer(jmodel, **kw) as js, ClusterServer(tmodel, device="cpu",
                                                    **kw) as ts:
        with JFrontend(js) as jfe, ClusterFrontend(ts) as tfe:
            yield jfe, tfe, jmodel, np.asarray(d.x), ckpt


def _request(url, path, data=None, headers=None, method=None):
    """(status, headers, body): errors returned, not raised."""
    req = urllib.request.Request(url + path, data=data,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post_json(url, path, obj, headers=None):
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    return _request(url, path, data=json.dumps(obj).encode(), headers=hdrs)


def _name(body: bytes) -> str:
    return json.loads(body)["error"]


# (what, request(url, x, d)) of requests the reference refuses
BAD = [
    ("not json", lambda u, x, d: _request(
        u, "/v1/assign", data=b"not json",
        headers={"Content-Type": "application/json"})),
    ("neither rows nor parts", lambda u, x, d: _post_json(
        u, "/v1/assign", {"nope": []})),
    ("a JSON list", lambda u, x, d: _post_json(u, "/v1/assign", [1, 2])),
    ("parts not a list", lambda u, x, d: _post_json(
        u, "/v1/assign", {"parts": 3})),
    ("two parts for dense", lambda u, x, d: _post_json(
        u, "/v1/assign", {"parts": [x[:2].tolist(), x[:2].tolist()]})),
    ("narrow rows", lambda u, x, d: _post_json(
        u, "/v1/assign", {"rows": x[:2, :d - 1].tolist()})),
    ("ragged raw body", lambda u, x, d: _request(
        u, "/v1/assign", data=b"\0" * (4 * d + 1),
        headers={"Content-Type": "application/octet-stream"})),
    ("1-D rows", lambda u, x, d: _post_json(
        u, "/v1/assign", {"rows": x[0].tolist()})),
    ("ragged rows", lambda u, x, d: _post_json(
        u, "/v1/assign", {"rows": [[0.0] * d, [0.0] * (d - 1)]})),
    ("negative deadline", lambda u, x, d: _post_json(
        u, "/v1/assign", {"rows": x[:2].tolist(), "deadline_ms": -5})),
    ("bad deadline header", lambda u, x, d: _post_json(
        u, "/v1/assign", {"rows": x[:2].tolist()},
        headers={"X-Deadline-Ms": "soon"})),
    ("zero deadline header", lambda u, x, d: _post_json(
        u, "/v1/assign", {"rows": x[:2].tolist()},
        headers={"X-Deadline-Ms": "0"})),
    ("too many rows", lambda u, x, d: _post_json(
        u, "/v1/assign", {"rows": [[0.0] * d] * 65})),
    ("unknown POST path", lambda u, x, d: _request(u, "/v1/nope",
                                                   data=b"{}")),
    ("unknown GET path", lambda u, x, d: _request(u, "/nope")),
    ("swap without ckpt", lambda u, x, d: _post_json(u, "/v1/swap", {})),
    ("swap of a missing dir", lambda u, x, d: _post_json(
        u, "/v1/swap", {"ckpt": "/no/such/dir"})),
    ("swap body not JSON", lambda u, x, d: _request(
        u, "/v1/swap", data=b"{", headers={"Content-Type":
                                           "application/json"})),
]


@pytest.mark.parametrize("what,go", BAD, ids=[b[0] for b in BAD])
def test_refused_requests_get_the_references_status_and_name(both, what, go):
    jfe, tfe, jmodel, x, _ = both
    d = int(jmodel.d)
    want_status, _, want_body = go(jfe.url, x, d)
    got_status, _, got_body = go(tfe.url, x, d)
    assert got_status == want_status >= 400, (what, got_body)
    assert _name(got_body) == _name(want_body)
    assert set(json.loads(got_body)) == {"error", "detail"}


@pytest.mark.parametrize("n", [1, 9, 64])
def test_json_assign_gives_the_references_labels(both, n):
    jfe, tfe, jmodel, x, _ = both
    outs = []
    for fe in (jfe, tfe):
        status, _, body = _post_json(fe.url, "/v1/assign",
                                     {"rows": x[:n].tolist(),
                                      "deadline_ms": 30_000})
        assert status == 200
        outs.append(json.loads(body))
    want, got = outs
    assert set(got) == set(want) == {"labels", "dists", "version"}
    assert got["version"] == tfe.server.version
    assert_labels_match(x[:n], np.asarray(jmodel.centers),
                        np.asarray(jmodel.center_valid),
                        np.asarray(want["labels"]), np.asarray(got["labels"]),
                        "json assign")
    np.testing.assert_allclose(got["dists"], want["dists"], rtol=1e-4,
                               atol=1e-4)


def test_raw_float32_assign_gives_the_references_bytes_layout(both):
    jfe, tfe, jmodel, x, _ = both
    outs = []
    for fe in (jfe, tfe):
        status, headers, body = _request(
            fe.url, "/v1/assign", data=x[:7].astype("<f4").tobytes(),
            headers={"Content-Type": "application/octet-stream",
                     "Accept": "application/octet-stream"})
        assert status == 200 and headers["X-Rows"] == "7"
        assert headers["Content-Type"] == "application/octet-stream"
        outs.append((np.frombuffer(body[:28], "<i4"),
                     np.frombuffer(body[28:], "<f4")))
    (wl, wd), (gl, gd) = outs
    assert_labels_match(x[:7], np.asarray(jmodel.centers),
                        np.asarray(jmodel.center_valid), wl, gl, "raw")
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-4)


def test_healthz_stats_and_swap_payloads(both):
    jfe, tfe, jmodel, x, ckpt = both
    for path in ("/healthz", "/v1/stats"):
        (ws, _, wb), (gs, _, gb) = (_request(fe.url, path)
                                    for fe in (jfe, tfe))
        assert gs == ws == 200
        if path == "/healthz":
            assert gb == wb == b"ok"
        else:
            want, got = json.loads(wb), json.loads(gb)
            assert set(got) == set(want)
            assert got["model"] == want["model"]
            assert set(got["engine"]) == set(want["engine"])
    outs = []
    for fe in (jfe, tfe):
        before = fe.server.version
        status, _, body = _post_json(fe.url, "/v1/swap", {"ckpt": ckpt})
        assert status == 200
        outs.append(json.loads(body))
        assert outs[-1] == {"version": before + 1}
    status, _, body = _post_json(tfe.url, "/v1/assign",
                                 {"rows": x[:5].tolist()})
    assert status == 200
    assert json.loads(body)["version"] == tfe.server.version


def test_raw_body_refused_for_code_space_models():
    with pytest.raises(FrontendError, match="dense models only") as e:
        _parse_assign(b"\0" * 16, "application/octet-stream", "sparse", 2,
                      4, 64)
    assert e.value.name == "KindMismatch" and e.value.status == 400


# ---------------------------------------------------------------------------
# deadline and engine-failure mapping, over a stand-in server
# ---------------------------------------------------------------------------

def _fake_frontend(submit):
    model = types.SimpleNamespace(transform=None, d=4, k_star=np.int32(1),
                                  metric="l2")
    server = types.SimpleNamespace(model=model, version=0, max_batch=64,
                                   submit=submit, stats=lambda: {},
                                   swap=None)
    return ClusterFrontend(server).start()


def _raises(exc):
    def submit(parts):
        raise exc
    return submit


def _failed(parts):
    fut = Future()
    fut.set_exception(ValueError("injected batch failure"))
    return fut


@pytest.mark.parametrize("submit,status,name,headers", [
    (lambda parts: Future(), 504, "DeadlineExceeded", {"X-Deadline-Ms":
                                                       "50"}),
    (_raises(ServerClosedError("server is closed")), 503, "ServerClosed",
     {}),
    (_raises(NotLeaderError("rank 1")), 503, "ServiceUnavailable", {}),
    (_raises(RuntimeError("serving worker died")), 503,
     "ServiceUnavailable", {}),
    (_raises(ValueError("part width")), 400, "BadRequest", {}),
    (_failed, 500, "AssignFailed", {}),
], ids=["deadline", "closed", "not leader", "dead worker", "late 400",
        "failed batch"])
def test_engine_failures_map_to_named_statuses(submit, status, name,
                                               headers):
    fe = _fake_frontend(submit)
    try:
        got, _, body = _post_json(fe.url, "/v1/assign",
                                  {"rows": [[0.0] * 4] * 2}, headers=headers)
        assert got == status and _name(body) == name
    finally:
        fe.close()


def test_observer_sees_parsed_traffic_and_never_breaks_serving(both):
    _, tfe, _, x, _ = both
    seen = []

    def observer(parts):
        seen.append(parts[0].shape[0])
        if len(seen) == 2:
            raise RuntimeError("observer bug")   # must not 500 the request

    with ClusterFrontend(tfe.server, observer=observer) as fe:
        for n in (3, 5, 7):
            assert _post_json(fe.url, "/v1/assign",
                              {"rows": x[:n].tolist()})[0] == 200
        st = json.loads(_request(fe.url, "/v1/stats")[2])
    assert seen == [3, 5, 7]
    assert st["http"]["observer_errors"] == 1 and st["http"]["requests"] == 3


def test_close_releases_the_socket_and_leaves_the_engine(both):
    _, tfe, _, x, _ = both
    fe = ClusterFrontend(tfe.server).start()
    host, port = fe.address
    assert _request(fe.url, "/healthz")[0] == 200
    with pytest.raises(RuntimeError, match="already started"):
        fe.start()
    fe.close()
    with pytest.raises((ConnectionError, urllib.error.URLError,
                        socket.timeout, OSError)):
        urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=2)
    assert tfe.server.submit(x[:4]).result(timeout=60).labels.shape == (4,)
