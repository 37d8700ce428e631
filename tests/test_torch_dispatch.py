"""``WorkerPool`` (``repro_torch.serve.dispatch``), ``ModelRegistry`` and
``utils.platform.worker_devices`` against ``repro``'s, on the CPU.

- **Routing**: for one request sequence, charges and releases included,
  the port's router picks the worker the reference's router picks, step
  by step (both pools hold two workers on one device, as the reference's
  own tests pin both to one CPU device).
- **Labels**: a two-worker pool on the CPU gives the direct ``predict``
  labels; a pool-wide swap is atomic per request and publishes once.
- **Registry**: keep-2 retention drops the oldest first, concurrent
  publishes get distinct monotonic versions, and ``load`` restores
  outside the lock.
- **Devices**: ``worker_devices`` returns n times the CPU when asked for
  it and raises, as the reference does, when too few exist.

Every wait on a future or a thread has a timeout of its own.
"""
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import repro_torch as rt
from _torch_dist import blobs
from repro.core.api import GEEK as JGEEK
from repro.core.api import DenseData as JDense
from repro.core.geek import GeekConfig as JConfig
from repro.serve import WorkerPool as JPool
from repro_torch.serve import ModelRegistry, ServerClosedError, WorkerPool
from repro_torch.utils import platform

torch.set_num_threads(1)

CFG_KW = dict(m=8, t=16, silk_l=3, delta=3, k_max=32, pair_cap=4096)
TIMEOUT = 60


def _fit(seed):
    (x,) = blobs("dense", 900, seed)
    model = rt.GEEK(rt.GeekConfig(**CFG_KW), device="cpu").fit(
        rt.DenseData(x), seed + 1)
    return model, x


@pytest.fixture(scope="module")
def fitted():
    return _fit(0)


@pytest.fixture(scope="module")
def fitted_b():
    return _fit(7)


def _pool(model, **kw):
    kw.setdefault("max_batch", 64)
    kw.setdefault("deadline_ms", 2.0)
    kw.setdefault("min_bucket", 16)
    return WorkerPool(model, devices=("cpu", "cpu"), **kw)


def _predict(model, x):
    return rt.predict(model, x)[0].numpy()


#: one request sequence: ("route", rows) or ("release", step index)
ROUTES = [("route", 30), ("route", 30), ("route", 30), ("route", 10),
          ("release", 0), ("route", 50), ("route", 64), ("release", 2),
          ("route", 1), ("release", 1), ("route", 33), ("route", 33),
          ("release", 5), ("release", 3), ("route", 20), ("route", 64),
          ("route", 5), ("release", 6)]


def test_routing_decisions_equal_the_references(fitted):
    """Drive both routers through ``ROUTES`` without serving (``_route``
    charges a worker, ``_uncharge`` is what a resolved future calls)."""
    from repro.data import synthetic
    d = synthetic.dense_blobs(jax.random.PRNGKey(0), n=300, d=16, k=4)
    jmodel = JGEEK(JConfig(**CFG_KW)).fit(JDense(d.x), jax.random.PRNGKey(1))
    dev = jax.devices()[0]
    jpool = JPool(jmodel, devices=(dev, dev), max_batch=64)
    pool = _pool(fitted[0], max_batch=64)
    try:
        picks = {"ref": [], "port": []}
        for name, p in (("ref", jpool), ("port", pool)):
            routed = []
            for op, arg in ROUTES:
                if op == "route":
                    routed.append((p._route(arg), arg))
                    picks[name].append(routed[-1][0])
                else:
                    p._uncharge(*routed[arg])
            picks[name].append(tuple(p.stats()["routing"].items()))
        assert picks["port"] == picks["ref"]
        assert picks["port"][-1][1] == ("spills", 8)   # both routers spilled
    finally:
        jpool.close()
        pool.close()


def test_pool_labels_equal_direct_predict(fitted):
    model, x = fitted
    want = _predict(model, x)
    with _pool(model) as pool:
        assert len(pool) == 2
        futs = [(i, pool.submit(x[i:i + 23])) for i in range(0, 400, 23)]
        for off, fut in futs:
            np.testing.assert_array_equal(fut.result(timeout=TIMEOUT).labels,
                                          want[off:off + 23])
    st = pool.stats()
    assert st["failed"] == 0 and st["rows_served"] >= 400
    assert len(st["workers"]) == 2


def test_a_burst_spreads_across_workers_and_releases_its_charges(fitted):
    model, x = fitted
    with _pool(model, max_batch=64, deadline_ms=20.0) as pool:
        futs = [pool.submit(x[i:i + 32]) for i in range(0, 320, 32)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        st = pool.stats()
    assert st["routing"]["spills"] >= 1
    assert all(w["rows_served"] > 0 for w in st["workers"])
    assert st["routing"]["queued_rows"] == [0, 0]


def test_pool_wide_swap_is_atomic_and_publishes_once(fitted, fitted_b):
    model_a, x = fitted
    model_b, _ = fitted_b
    by_version = {0: model_a, 1: model_b}
    with _pool(model_a, deadline_ms=3.0) as pool:
        pool.warmup(x[:8])
        assert pool.submit(x[:8]).result(timeout=TIMEOUT).version == 0
        futs = []
        for i in range(12):
            if i == 6:
                assert pool.swap(model_b) == 1
            futs.append((8 * i, pool.submit(x[8 * i:8 * i + 8])))
            time.sleep(0.002)
        seen = set()
        for off, fut in futs:
            got = fut.result(timeout=TIMEOUT)
            seen.add(got.version)
            np.testing.assert_array_equal(
                got.labels, _predict(by_version[got.version], x[off:off + 8]))
        assert pool.registry.versions(pool.name) == [0, 1]
        assert all(s.version == 1 for s in pool.servers)
        assert pool.registry.get(pool.name, 0).model is model_a
        st = pool.stats()
    assert 1 in seen and st["failed"] == 0


def test_pool_specs_close_and_checkpoints(fitted, tmp_path):
    model, x = fitted
    with pytest.raises(ValueError, match="disagrees"):
        WorkerPool(model, workers=3, devices=("cpu",))
    with pytest.raises(TypeError, match="GeekModel"):
        WorkerPool(object(), devices=("cpu",))
    rt.save_model(str(tmp_path), model)
    with WorkerPool(str(tmp_path), workers=2, devices=("cpu", "cpu"),
                    max_batch=64, min_bucket=16) as pool:
        np.testing.assert_array_equal(
            pool.submit(x[:9]).result(timeout=TIMEOUT).labels,
            _predict(model, x[:9]))
        assert pool.swap(str(tmp_path)) == 1
    with pytest.raises(ServerClosedError):
        pool.submit(x[:4])


def test_worker_devices():
    assert platform.worker_devices(3, device="cpu") == (
        torch.device("cpu"),) * 3
    assert platform.worker_devices(device="cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="at least 1"):
        platform.worker_devices(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            platform.worker_devices(1)
    else:
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match="worker devices requested"):
            platform.worker_devices(n + 1)


def test_platform_args():
    import argparse
    ap = argparse.ArgumentParser()
    platform.add_platform_args(ap)
    args = ap.parse_args(["--device", "cpu"])
    assert platform.apply_platform_args(args) == torch.device("cpu")
    with pytest.raises(SystemExit):
        ap.parse_args(["--device", "tpu"])


# ---------------------------------------------------------------------------
# registry retention
# ---------------------------------------------------------------------------

def _dummy_model(d=8):
    return types.SimpleNamespace(transform=None, d=d)


def test_registry_keep2_eviction_order():
    reg = ModelRegistry(keep=2)
    models = [_dummy_model() for _ in range(4)]
    for m in models:
        reg.publish("m", m)
    assert reg.versions("m") == [2, 3]
    assert reg.get("m", 2).model is models[2]
    assert reg.get("m", 3).model is models[3]
    for gone in (0, 1):
        with pytest.raises(KeyError):
            reg.get("m", gone)
    with pytest.raises(ValueError, match="keep"):
        ModelRegistry(keep=0)
    with pytest.raises(KeyError):
        reg.current("absent")
    assert reg.names() == ["m"]


def test_registry_refuses_incompatible_publishes():
    reg = ModelRegistry()
    kinded = types.SimpleNamespace
    reg.publish("m", kinded(transform=kinded(kind="identity"), d=16))
    with pytest.raises(ValueError, match="kind mismatch"):
        reg.publish("m", kinded(transform=kinded(kind="sparse"), d=16))
    with pytest.raises(ValueError, match="width mismatch"):
        reg.publish("m", kinded(transform=kinded(kind="identity"), d=8))
    assert reg.publish("m", kinded(transform=kinded(kind="sparse"), d=8),
                       check_compatible=False) == 1


def test_registry_concurrent_publishes_serialize_monotonic():
    reg = ModelRegistry(keep=100)
    got: list[int] = []
    lock = threading.Lock()

    def publisher():
        for _ in range(25):
            v = reg.publish("m", _dummy_model())
            with lock:
                got.append(v)

    threads = [threading.Thread(target=publisher) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert sorted(got) == list(range(100))
    assert reg.versions("m") == list(range(100))


def test_registry_load_restores_outside_the_lock(monkeypatch):
    import repro_torch.checkpoint.manager as ckpt_mod
    reg = ModelRegistry()
    reg.publish("m", _dummy_model())
    in_restore = threading.Event()
    release = threading.Event()

    def slow_restore(directory, step=None, mesh=None, device=None):
        in_restore.set()
        assert release.wait(timeout=TIMEOUT), "reader never released us"
        return _dummy_model()

    monkeypatch.setattr(ckpt_mod, "restore_model", slow_restore)
    t = threading.Thread(target=reg.load, args=("m", "ignored"))
    t.start()
    try:
        assert in_restore.wait(timeout=TIMEOUT)
        assert reg.current("m").version == 0
        assert reg.versions("m") == [0]
    finally:
        release.set()
        t.join(timeout=TIMEOUT)
    assert reg.current("m").version == 1
