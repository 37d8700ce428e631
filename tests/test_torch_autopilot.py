"""``RefitAutopilot`` (``repro_torch.serve.autopilot``) on the CPU, against
``repro.serve.autopilot``'s contracts.

- **The reservoir** is the reference's row for row: the same observed
  batches and seed leave the same rows in both (Algorithm R on numpy's
  generator, as the reference draws it); below capacity it keeps every
  row, and below ``min_rows`` a cycle skips.
- **A refit publishes a valid model**: it passes its own gates, the server
  serves it (labels = its ``predict``), and a refit from a seed is the
  facade's fit from that seed.
- **A poisoned refit rolls back**: a vetoing validator or the ``k_star``
  gate keeps the incumbent serving and names the failed gates.
- Requests racing a live refit serve exactly the version they report; a
  second ``run_once`` skips instead of stacking; the background clock
  refits and stops.

Every wait on a future or a thread has a timeout of its own.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import repro_torch as rt
from _torch_dist import blobs
from repro.serve import ClusterServer as JServer
from repro.serve import RefitAutopilot as JAutopilot
from repro_torch.serve import ClusterServer, RefitAutopilot, WorkerPool

torch.set_num_threads(1)

CFG = rt.GeekConfig(m=8, t=16, silk_l=3, delta=3, k_max=32, pair_cap=4096)
TIMEOUT = 120


@pytest.fixture(scope="module")
def fitted():
    (x,) = blobs("dense", 900, 0)
    model = rt.GEEK(CFG, device="cpu").fit(rt.DenseData(x), 1)
    return model, x


def _server(model, **kw):
    kw.setdefault("max_batch", 64)
    kw.setdefault("deadline_ms", 2.0)
    kw.setdefault("min_bucket", 16)
    return ClusterServer(model, device="cpu", **kw)


def _predict(model, x):
    return rt.predict(model, x)[0].numpy()


# ---------------------------------------------------------------------------
# reservoir
# ---------------------------------------------------------------------------

def test_reservoir_is_the_references_row_for_row(fitted):
    """The same batches and seed, into both packages' autopilots."""
    from repro.core.api import GEEK as JGEEK
    from repro.core.api import DenseData as JDense
    from repro.core.geek import GeekConfig as JConfig
    model, x = fitted
    jmodel = JGEEK(JConfig(m=8, t=16, silk_l=3, delta=3, k_max=32,
                           pair_cap=4096)).fit(JDense(x[:300]),
                                               jax.random.PRNGKey(0))
    with _server(model) as server, JServer(jmodel) as jserver:
        ap = RefitAutopilot(server, CFG, reservoir=64, seed=3)
        jap = JAutopilot(jserver, CFG, reservoir=64, seed=3)
        for a, b in ((0, 50), (50, 51), (51, 300), (300, 800)):
            ap.observe(x[a:b])
            jap.observe(x[a:b])
        np.testing.assert_array_equal(ap._buffers[0], jap._buffers[0])
        assert ap.stats()["observed_rows"] == jap.stats()["observed_rows"]
        assert ap.stats()["reservoir_rows"] == 64
        assert not np.array_equal(ap._buffers[0], x[:64])


def test_reservoir_keeps_everything_below_capacity(fitted):
    model, x = fitted
    with _server(model) as server:
        ap = RefitAutopilot(server, CFG, reservoir=256, min_rows=300)
        ap.observe(x[:100])
        ap.observe((torch.from_numpy(x[100:150]),))   # tensors too
        st = ap.stats()
        assert st["observed_rows"] == st["reservoir_rows"] == 150
        np.testing.assert_array_equal(ap._buffers[0][:150], x[:150])
        assert ap.run_once() is None                   # below min_rows
        assert ap.stats()["skipped"] == 1 and ap.stats()["refits"] == 0
        with pytest.raises(ValueError, match="reservoir"):
            RefitAutopilot(server, CFG, reservoir=0)


# ---------------------------------------------------------------------------
# publish and rollback
# ---------------------------------------------------------------------------

def test_refit_publishes_a_validated_model(fitted):
    model, x = fitted
    with _server(model) as server:
        ap = RefitAutopilot(server, CFG, reservoir=1024, min_rows=128,
                            holdout=64, seed=7)
        ap.observe(x)
        assert server.version == 0
        assert ap.run_once() == 1 and server.version == 1
        st = ap.stats()
        assert (st["refits"], st["published"], st["rollbacks"]) == (1, 1, 0)
        assert st["last_rejection"] is None
        new = server.model
        # the refit is the facade's fit of the reservoir from seed 7 + 1
        want = rt.GEEK(CFG, device="cpu").fit(rt.DenseData(x), 8)
        assert torch.equal(new.centers, want.centers)
        got = server.submit(x[:16]).result(timeout=TIMEOUT)
        assert got.version == 1
        np.testing.assert_array_equal(got.labels, _predict(new, x[:16]))


@pytest.mark.parametrize("gate", ["veto", "k_star"])
def test_a_poisoned_refit_rolls_back(fitted, gate):
    model, x = fitted
    with _server(model) as server:
        kw = (dict(validator=lambda m, r, p: (False, "injected fault"))
              if gate == "veto" else dict(max_k_star=1))
        ap = RefitAutopilot(server, CFG, reservoir=1024, min_rows=128,
                            seed=7, **kw)
        ap.observe(x)
        assert ap.run_once() is None
        assert server.version == 0
        assert server.registry.versions(server.name) == [0]
        st = ap.stats()
        assert (st["published"], st["rollbacks"]) == (0, 1)
        rej = st["last_rejection"]
        assert rej["incumbent_version"] == 0
        if gate == "veto":
            assert any("injected fault" in g for g in rej["gates"])
        else:
            assert any(g.startswith("k_star") for g in rej["gates"])
            assert rej["k_star"] > 1


def test_no_mixed_versions_during_a_live_refit(fitted):
    model, x = fitted
    with WorkerPool(model, devices=("cpu", "cpu"), max_batch=64,
                    deadline_ms=2.0, min_bucket=16) as pool:
        ap = RefitAutopilot(pool, CFG, reservoir=1024, min_rows=128,
                            holdout=32, seed=7)
        ap.observe(x)
        published = []
        t = threading.Thread(target=lambda: published.append(ap.run_once()))
        futs = []
        t.start()
        for i in range(40):
            futs.append((8 * i, pool.submit(x[8 * i:8 * i + 8])))
        t.join(timeout=TIMEOUT)
        assert published == [1]
        seen = set()
        for off, fut in futs:
            got = fut.result(timeout=TIMEOUT)
            seen.add(got.version)
            served_by = pool.registry.get(pool.name, got.version).model
            np.testing.assert_array_equal(got.labels,
                                          _predict(served_by, x[off:off + 8]))
        assert seen <= {0, 1} and pool.stats()["failed"] == 0


def test_concurrent_run_once_skips_instead_of_stacking(fitted):
    model, x = fitted
    with _server(model) as server:
        ap = RefitAutopilot(server, CFG, reservoir=1024, min_rows=128,
                            seed=7)
        ap.observe(x)
        entered, release = threading.Event(), threading.Event()

        def gate(candidate, result, parts):
            entered.set()
            release.wait(timeout=TIMEOUT)
            return True, ""

        ap.validator = gate
        t = threading.Thread(target=ap.run_once)
        t.start()
        try:
            assert entered.wait(timeout=TIMEOUT)
            assert ap.run_once() is None
            assert ap.stats()["skipped"] == 1
        finally:
            release.set()
            t.join(timeout=TIMEOUT)
        assert ap.stats()["published"] == 1


def test_background_loop_refits_on_the_clock_and_stops(fitted):
    model, x = fitted
    with _server(model) as server:
        ap = RefitAutopilot(server, CFG, reservoir=1024, min_rows=128,
                            holdout=32, refit_every_s=0.05, seed=7)
        with pytest.raises(RuntimeError, match="already started"):
            ap.start()
            ap.start()
        ap.close()
        ap = RefitAutopilot(server, CFG, reservoir=1024, min_rows=128,
                            holdout=32, refit_every_s=0.05, seed=7)
        ap.observe(x)
        with ap.start():
            wait = threading.Event()
            for _ in range(400):
                if ap.stats()["published"] >= 1:
                    break
                wait.wait(0.05)
        assert ap.stats()["published"] >= 1 and server.version >= 1
        settled = ap.stats()["refits"]
        threading.Event().wait(0.2)
        assert ap.stats()["refits"] == settled
        with pytest.raises(ValueError, match="refit_every_s"):
            RefitAutopilot(server, CFG).start()
