"""The serving engine (``repro_torch.serve.engine``, ``registry``) against
``repro.serve``'s contracts, on the CPU.

- **The pad ladder** is the reference's, rung for rung, over a grid of
  ``(max_batch, min_bucket, multiple)``, and so is ``bucket_for``.
- **Labels from a checkpoint written by ``repro``.** A model fitted and
  saved by the reference is restored in the port and served by
  ``ClusterServer(device="cpu")``; the served labels equal the
  reference's ``predict`` on the same rows for dense, hetero and sparse
  data, exact and probed (``probes=1``; the index on the reference's own
  hash functions, injected through ``model_from_numpy(index_hashers=)``).
  Dense labels are held but at near-ties (counted and named); Hamming
  labels and distances bit for bit (d = 9 and 64, where the reference's
  CPU division by d is exact). Dense distances: squares within 1e-5 of the
  expansion's scale. Dense labels also equal the reference's own
  ``ClusterServer``'s.
- **Flush reasons**: a full bucket flushes at once (``max_batch``), a
  partial one at its deadline, a full bucket outranks an expired deadline,
  ``close`` drains.
- **Hot-swap atomicity**: a swap mid-stream fails no request, and every
  request's labels are the predict of the version it reports.
- **Failures**: a step that raises at dispatch or at retire fails its
  micro-batch only; a worker-killing error resolves every future and
  poisons ``submit``; ``submit`` after ``close`` raises
  ``ServerClosedError``, also when it races the close.
- **``mesh=``** at g = 1 (in process) and g = 2 (two spawned gloo ranks,
  ``_torch_dist.serve_outputs``): rank 0's served labels equal
  ``predict``; the other rank refuses ``submit`` with ``NotLeaderError``
  and ends when rank 0 closes.
- **No silent CPU**: without a card a server asked for no device raises.

Every wait on a future or a thread has a timeout of its own.
"""
import dataclasses
import functools
import json
import os
import time
import types

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from _torch_dist import SERVE_SIZES, blobs, run_ranks, serve_outputs, \
    single_rank_group
from _torch_parity import assert_labels_match
from repro.checkpoint import manager as jmgr
from repro.core import model as jm
from repro.serve import ClusterServer as JServer
from repro.serve import engine as jengine
from repro_torch.checkpoint import manager as tmgr
from repro_torch.serve import ClusterServer, ModelRegistry, pad_ladder
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import (NotLeaderError, ServerClosedError,
                                      bucket_for)

torch.set_num_threads(1)

CFG_KW = dict(m=8, t=16, silk_l=3, delta=3, k_max=32, pair_cap=4096,
              t_cat=8)
TIMEOUT = 60


# ---------------------------------------------------------------------------
# the pad ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch", [1, 5, 64, 100, 1000, 4096])
@pytest.mark.parametrize("min_bucket", [1, 16, 64])
@pytest.mark.parametrize("multiple", [1, 2, 3, 8])
def test_pad_ladder_is_the_references(max_batch, min_bucket, multiple):
    lad = pad_ladder(max_batch, min_bucket=min_bucket, multiple=multiple)
    assert lad == jengine.pad_ladder(max_batch, min_bucket=min_bucket,
                                     multiple=multiple)
    for n in range(1, lad[-1] + 1, max(1, lad[-1] // 97)):
        assert bucket_for(n, lad) == jengine.bucket_for(n, lad)
    with pytest.raises(ValueError, match="exceeds"):
        bucket_for(lad[-1] + 1, lad)


def test_pad_ladder_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        pad_ladder(0)


# ---------------------------------------------------------------------------
# models: fitted by the reference (parity) and by the port (contracts)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_fit(kind: str):
    """(jax model, raw numpy parts) of one kind, fitted by ``repro``."""
    from repro.data import synthetic
    key, fkey = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    cfg = repro.GeekConfig(**CFG_KW)
    if kind == "dense":
        d = synthetic.dense_blobs(key, n=900, d=16, k=8)
        parts = (np.asarray(d.x),)
        data = repro.DenseData(d.x)
    elif kind == "hetero":
        h = synthetic.geonames_like(key, n=700, k=8)
        parts = (np.asarray(h.x_num), np.asarray(h.x_cat))
        data = repro.HeteroData(h.x_num, h.x_cat)
    else:
        s = synthetic.url_like(key, n=600, k=8)
        parts = (np.asarray(s.sets), np.asarray(s.mask))
        data = repro.SparseData(s.sets, s.mask)
    model = repro.GEEK(cfg).fit(data, fkey)
    return jax.block_until_ready(model), parts


def _port_from_reference(kind: str, tmp_path, probed: bool):
    """The reference's model through its checkpoint into the port: by
    ``restore_model``, or, for probed serving, by ``model_from_numpy``
    with the reference's index hashers."""
    jmodel, parts = _reference_fit(kind)
    path = str(tmp_path / kind)
    jmgr.save_model(path, jmodel)
    if not probed:
        return jmodel, rt.restore_model(path, device="cpu"), parts
    step = tmgr._step_dir(path, tmgr._latest_step(path))
    with open(os.path.join(step, "manifest.json")) as fh:
        manifest = json.load(fh)
    extra = manifest["extra"]
    arrays = {f: np.load(os.path.join(step, leaf["file"]))
              for f, leaf in zip(extra["fields"], manifest["leaves"])}
    hashers = tuple(np.asarray(h) for h in jmodel.center_index.hashers)
    return jmodel, tmgr.model_from_numpy(arrays, extra, "cpu",
                                         index_hashers=hashers), parts


@functools.lru_cache(maxsize=None)
def _fitted(seed: int = 0):
    """(port model, dense rows) fitted by the port on the CPU."""
    (x,) = blobs("dense", 900, seed)
    model = rt.GEEK(rt.GeekConfig(**CFG_KW), device="cpu").fit(
        rt.DenseData(x), seed + 1)
    return model, x


def _direct(model, x, probes=None):
    lab, dst = rt.predict(model, x, probes=probes)
    return lab.numpy(), dst.numpy()


def _server(model, **kw):
    kw.setdefault("device", "cpu")
    return ClusterServer(model, **kw)


def _rows(parts, off, n):
    return tuple(None if p is None else p[off:off + n] for p in parts)


# ---------------------------------------------------------------------------
# served labels = the reference's predict, on its checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probes", [None, 1])
@pytest.mark.parametrize("kind", ["dense", "hetero", "sparse"])
def test_served_labels_equal_the_references_predict(kind, probes, tmp_path):
    """The index's probe window (3 bucket hops of 32 for l2, 4 for
    Hamming) covers every one of the k_max = 32 centers here, so probed
    serving is the exact argmin on both sides."""
    jmodel, tmodel, parts = _port_from_reference(kind, tmp_path,
                                                 probes is not None)
    sizes = (1, 7, 16, 33, 100, 64, 3)
    with _server(tmodel, probes=probes, max_batch=128, min_bucket=16,
                 deadline_ms=5.0) as server:
        server.warmup(_rows(parts, 0, 16))
        futs, off = [], 0
        for n in sizes:
            futs.append((off, n, server.submit(_rows(parts, off, n))))
            off += n
        # the reference on all the rows in one call (rows are independent)
        all_l, all_d = jm.predict(jmodel, jmodel.encode(*_rows(parts, 0,
                                                              off)),
                                  probes=probes)
        for off, n, fut in futs:
            got = fut.result(timeout=TIMEOUT)
            rows = _rows(parts, off, n)
            wl = np.asarray(all_l)[off:off + n]
            wd = np.asarray(all_d)[off:off + n]
            assert got.labels.dtype == np.int32 and got.version == 0
            if kind == "dense":
                c = np.asarray(jmodel.centers)
                assert_labels_match(rows[0], c, np.asarray(
                    jmodel.center_valid), wl, got.labels,
                    f"served {kind} probes={probes}")
                scale = (rows[0].astype(np.float64) ** 2).sum(1) + (
                    c.astype(np.float64) ** 2).sum(1).max()
                err = np.abs(got.dists.astype(np.float64) ** 2
                             - wd.astype(np.float64) ** 2)
                assert (err <= 1e-5 * scale).all()
            else:
                np.testing.assert_array_equal(got.labels, wl)
                np.testing.assert_array_equal(got.dists, wd)
        st = server.stats()
    assert st["failed"] == 0 and st["rows_served"] == sum(sizes)


def test_served_dense_labels_equal_the_references_server(tmp_path):
    jmodel, tmodel, parts = _port_from_reference("dense", tmp_path, False)
    (x,) = parts
    with JServer(jmodel, max_batch=128, min_bucket=16) as jserver, \
            _server(tmodel, max_batch=128, min_bucket=16) as server:
        for off, n in ((0, 5), (5, 60), (65, 128)):
            want = jserver.submit(x[off:off + n]).result(timeout=TIMEOUT)
            got = server.submit(x[off:off + n]).result(timeout=TIMEOUT)
            assert_labels_match(x[off:off + n], np.asarray(jmodel.centers),
                                np.asarray(jmodel.center_valid),
                                want.labels, got.labels, "vs the server")
            assert got.version == want.version == 0


def test_multi_part_requests_disagreeing_on_rows_are_refused(tmp_path):
    _, tmodel, parts = _port_from_reference("hetero", tmp_path, False)
    with _server(tmodel, max_batch=32) as server:
        with pytest.raises(ValueError, match="disagree"):
            server.submit((parts[0][:4], parts[1][:5]))
        with pytest.raises(ValueError, match="query part"):
            server.submit((parts[0][:4],))


# ---------------------------------------------------------------------------
# flush ordering
# ---------------------------------------------------------------------------

def test_single_row_requests_batch_together():
    model, x = _fitted()
    with _server(model, max_batch=64, deadline_ms=20.0,
                 min_bucket=16) as server:
        futs = [server.submit(x[i:i + 1]) for i in range(32)]
        want, _ = _direct(model, x[:32])
        for i, fut in enumerate(futs):
            got = fut.result(timeout=TIMEOUT)
            assert got.labels.shape == (1,) and got.labels[0] == want[i]
        st = server.stats()
    assert st["batches"] < 32, "1-row requests must micro-batch"


def test_full_bucket_flushes_without_waiting_for_deadline():
    model, x = _fitted()
    with _server(model, max_batch=32, deadline_ms=60_000.0,
                 min_bucket=16) as server:
        futs = [server.submit(x[8 * i:8 * i + 8]) for i in range(4)]
        t0 = time.monotonic()
        for fut in futs:
            fut.result(timeout=TIMEOUT)
        assert time.monotonic() - t0 < 30, "flush waited for the deadline"
        st = server.stats()
    assert st["flushes"]["max_batch"] >= 1
    assert st["flushes"]["deadline"] == 0


def test_partial_bucket_flushes_at_deadline():
    model, x = _fitted()
    with _server(model, max_batch=4096, deadline_ms=25.0,
                 min_bucket=16) as server:
        got = server.submit(x[:8]).result(timeout=TIMEOUT)
        assert got.labels.shape == (8,)
        st = server.stats()
    assert st["flushes"] == {"max_batch": 0, "deadline": 1, "close": 0}
    assert st["padded_rows"] == 8


def test_max_batch_outranks_expired_deadline(monkeypatch):
    """A parked worker and a backdated request: the flush is a
    ``max_batch`` one."""
    model, x = _fitted()
    orig_run = engine_mod.ClusterServer._run
    monkeypatch.setattr(engine_mod.ClusterServer, "_run",
                        lambda self: None)   # the worker exits at once
    server = _server(model, max_batch=32, deadline_ms=5.0, min_bucket=16)
    fut = server.submit(x[:32])              # exactly max_batch
    req = server._queue.get_nowait()
    req.t_submit = time.monotonic() - 10.0   # the deadline long gone
    server._queue.put(req)
    server._queue.put(engine_mod._CLOSE)
    orig_run(server)                         # the loop, inline
    assert fut.result(timeout=5).labels.shape == (32,)
    assert server.stats()["flushes"] == {"max_batch": 1, "deadline": 0,
                                         "close": 0}


def test_close_drains_pending_requests():
    model, x = _fitted()
    server = _server(model, max_batch=4096, deadline_ms=60_000.0,
                     min_bucket=16)
    futs = [server.submit(x[8 * i:8 * i + 8]) for i in range(3)]
    server.close()
    want, _ = _direct(model, x[:24])
    for i, fut in enumerate(futs):
        np.testing.assert_array_equal(fut.result(timeout=5).labels,
                                      want[8 * i:8 * i + 8])
    assert server.stats()["flushes"]["close"] >= 1
    assert not server._worker.is_alive()


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------

def test_hot_swap_is_atomic_and_loses_nothing():
    model_a, x = _fitted(0)
    model_b, _ = _fitted(7)
    assert not torch.equal(model_a.centers, model_b.centers)
    by_version = {0: model_a, 1: model_b}
    with _server(model_a, max_batch=64, deadline_ms=3.0,
                 min_bucket=16) as server:
        assert server.submit(x[:8]).result(timeout=TIMEOUT).version == 0
        futs = []
        for i in range(12):
            if i == 6:
                assert server.swap(model_b) == 1
            futs.append((8 * i, server.submit(x[8 * i:8 * i + 8])))
            time.sleep(0.002)
        seen = set()
        for off, fut in futs:
            got = fut.result(timeout=TIMEOUT)
            seen.add(got.version)
            want, _ = _direct(by_version[got.version], x[off:off + 8])
            np.testing.assert_array_equal(got.labels, want)
        st = server.stats()
    assert 1 in seen and st["failed"] == 0 and st["swaps"] == 1


def _dummy(kind="identity", d=16):
    return types.SimpleNamespace(
        transform=types.SimpleNamespace(kind=kind), d=d,
        device=torch.device("cpu"))


def test_swap_refuses_incompatible_model():
    model, _ = _fitted()
    with _server(model, max_batch=32) as server:
        with pytest.raises(ValueError, match="kind mismatch"):
            server.swap(_dummy("sparse", model.d))
        with pytest.raises(ValueError, match="width mismatch"):
            server.swap(_dummy("identity", model.d + 1))
        assert server.version == 0


def test_server_and_registry_restore_from_checkpoint_dirs(tmp_path):
    model, x = _fitted()
    rt.save_model(str(tmp_path), model)
    with ClusterServer(str(tmp_path), device="cpu", max_batch=64,
                       min_bucket=16) as server:
        got = server.submit(x[:20]).result(timeout=TIMEOUT)
        np.testing.assert_array_equal(got.labels, _direct(model, x[:20])[0])
        assert server.swap(str(tmp_path)) == 1
        assert server.registry.current("default").source == str(tmp_path)
    reg = ModelRegistry()
    assert reg.load("m", str(tmp_path), device="cpu") == 0
    assert reg.current("m").model.device.type == "cpu"


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_submit_and_constructor_validation():
    model, x = _fitted()
    with _server(model, max_batch=32) as server:
        with pytest.raises(ValueError, match="query part"):
            server.submit((x[:4], x[:4]))
        with pytest.raises(ValueError, match="outside"):
            server.submit(x[:33])
    with pytest.raises(TypeError, match="GeekModel"):
        _server(12345)
    with pytest.raises(ValueError, match="probes"):
        _server(model, probes=-1)
    with pytest.raises(ValueError, match="deadline_ms"):
        _server(model, deadline_ms=0)
    no_index = dataclasses.replace(model, center_index=None, index_tables=0)
    with pytest.raises(ValueError, match="index_tables=0"):
        _server(no_index, probes=1)


def test_ladder_override_serves_on_custom_rungs():
    model, x = _fitted()
    rungs = (8, 24, 64)
    with _server(model, max_batch=64, deadline_ms=2.0,
                 ladder=rungs) as server:
        assert server.ladder == rungs
        for n in (3, 8, 20, 60):
            got = server.submit(x[:n]).result(timeout=TIMEOUT)
            np.testing.assert_array_equal(got.labels, _direct(model, x[:n])[0])
        st = server.stats()
    assert st["padded_rows"] == 13          # 3->8, 8->8, 20->24, 60->64


def test_ladder_override_validation_and_device_with_mesh(tmp_path):
    model, _ = _fitted()
    for bad, msg in (((), "strictly"), ((16, 16, 64), "strictly"),
                     ((0, 64), "strictly"), ((16, 32), "cover")):
        with pytest.raises(ValueError, match=msg):
            _server(model, max_batch=64, ladder=bad)
    with single_rank_group(tmp_path):
        with pytest.raises(ValueError, match="cannot compose"):
            ClusterServer(model, mesh=rt.make_mesh(), device="cpu")


def test_no_card_and_no_device_raises_instead_of_serving_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None serves on it")
    model, _ = _fitted()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterServer(model)


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------

class _Boom(RuntimeError):
    pass


def _raising_step(*_a, **_k):
    raise _Boom("injected dispatch failure")


class _Poison:
    """An output whose read-back fails: a retire-time fault."""

    def __getitem__(self, _):
        raise _Boom("injected retire failure")


def test_dispatch_failure_is_contained(monkeypatch):
    model, x = _fitted()
    with _server(model, max_batch=32, deadline_ms=2.0) as server:
        monkeypatch.setattr(engine_mod, "_exact_step", _raising_step)
        doomed = [server.submit(x[4 * i:4 * i + 4]) for i in range(3)]
        for fut in doomed:
            with pytest.raises(_Boom, match="dispatch"):
                fut.result(timeout=TIMEOUT)
        monkeypatch.undo()
        assert server.submit(x[:8]).result(timeout=TIMEOUT).labels.shape \
            == (8,)
        st = server.stats()
    assert st["failed"] >= 3 and st["completed"] >= 1


def test_retire_failure_is_contained(monkeypatch):
    model, x = _fitted()
    with _server(model, max_batch=32, deadline_ms=2.0) as server:
        monkeypatch.setattr(engine_mod, "_exact_step",
                            lambda *_a: (_Poison(), _Poison()))
        with pytest.raises(_Boom, match="retire"):
            server.submit(x[:8]).result(timeout=TIMEOUT)
        monkeypatch.undo()
        assert server.submit(x[:8]).result(timeout=TIMEOUT).labels.shape \
            == (8,)
    assert server.stats()["failed"] >= 1


def test_fatal_error_resolves_all_and_poisons_submit(monkeypatch):
    model, x = _fitted()
    server = _server(model, max_batch=256, deadline_ms=40.0)
    try:
        def lethal_flush(*_a, **_k):
            raise _Boom("worker-killing bug")
        monkeypatch.setattr(server, "_flush", lethal_flush)
        futs = [server.submit(x[i:i + 1]) for i in range(5)]
        for fut in futs:
            with pytest.raises(_Boom, match="worker-killing"):
                fut.result(timeout=TIMEOUT)
        with pytest.raises(RuntimeError, match="worker died"):
            server.submit(x[:1])
        assert server.stats()["failed"] == 5
    finally:
        server.close()
    server.close()                            # idempotent after death


def test_failed_and_poisoned_swaps_fail_their_own_batches_only(
        monkeypatch, tmp_path):
    model, x = _fitted()
    poisoned = dataclasses.replace(model)     # a distinct object
    real = engine_mod._exact_step

    def selective(m, parts):
        if m is poisoned:
            raise _Boom("poisoned model")
        return real(m, parts)

    with _server(model, max_batch=32, deadline_ms=2.0) as server:
        with pytest.raises(FileNotFoundError):
            server.swap(str(tmp_path / "no_such_ckpt"))
        assert server.version == 0
        monkeypatch.setattr(engine_mod, "_exact_step", selective)
        assert server.submit(x[:4]).result(timeout=TIMEOUT).version == 0
        server.swap(poisoned)
        with pytest.raises(_Boom, match="poisoned"):
            server.submit(x[:4]).result(timeout=TIMEOUT)
        server.swap(model)
        assert server.submit(x[:4]).result(timeout=TIMEOUT).version == 2
        st = server.stats()
    assert st["failed"] == 1 and st["swaps"] == 2


def test_submit_after_close_raises_named_error():
    model, x = _fitted()
    server = _server(model, max_batch=32, deadline_ms=2.0)
    server.close()
    with pytest.raises(ServerClosedError, match="closed"):
        server.submit(x[:4])
    assert issubclass(ServerClosedError, RuntimeError)
    server.close()


def test_submit_racing_close_never_hangs(monkeypatch):
    """submit passes the closed pre-check, then a whole close() runs
    before the request lands on the queue: the future still resolves."""
    model, x = _fitted()
    server = _server(model, max_batch=32, deadline_ms=2.0)
    real_put = server._queue.put
    fired = []

    def racing_put(item):
        if not fired and hasattr(item, "future"):
            fired.append(item)
            monkeypatch.setattr(server._queue, "put", real_put,
                                raising=False)
            server.close()
        real_put(item)

    monkeypatch.setattr(server._queue, "put", racing_put, raising=False)
    fut = server.submit(x[:4])
    with pytest.raises(ServerClosedError, match="closed"):
        fut.result(timeout=TIMEOUT)
    assert not server._worker.is_alive()


# ---------------------------------------------------------------------------
# mesh= serving over gloo ranks
# ---------------------------------------------------------------------------

def _check_mesh_results(model, results):
    (x,) = blobs("dense", sum(SERVE_SIZES), 7)
    for probes, out in results.items():
        for (off, labels, dists, version), n in zip(out["results"],
                                                    SERVE_SIZES):
            want_l, want_d = _direct(model, x[off:off + n], probes=probes)
            np.testing.assert_array_equal(labels, want_l)
            np.testing.assert_array_equal(dists, want_d)
            assert version == 0
        assert out["stats"]["failed"] == 0


def test_mesh_serving_one_rank(tmp_path):
    model, _ = _fitted()
    rt.save_model(str(tmp_path / "ckpt"), model)
    with single_rank_group(tmp_path):
        out = serve_outputs(0, 1, str(tmp_path / "ckpt"))
    _check_mesh_results(model, out)


def test_mesh_serving_two_ranks(tmp_path):
    model, _ = _fitted()
    rt.save_model(str(tmp_path / "ckpt"), model)
    leader, follower = run_ranks(serve_outputs, 2, str(tmp_path), 240,
                                 ckpt_dir=str(tmp_path / "ckpt"))
    _check_mesh_results(model, leader)
    for probes in (None, 1):
        assert all(r % 2 == 0 for r in leader[probes]["ladder"])
        assert follower[probes] == dict(refused=True, alive=False)


def test_not_leader_error_is_named():
    assert issubclass(NotLeaderError, RuntimeError)
