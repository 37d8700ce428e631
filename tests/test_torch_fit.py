"""The whole slice: ``repro.GEEK.fit`` vs ``repro_torch.GEEK.fit``, predict,
checkpoints both ways, the reference fixture, and the port's rules
(no JAX in the port, no silent CPU fallback).
"""
import ast
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from _torch_dist import single_rank_group
from _torch_parity import (InjectedBucketer, assert_labels_match, carrier,
                           jax_draws)
from repro_torch.core import model as tmodel_mod
from repro.checkpoint import manager as jmgr
from repro.core import api as japi
from repro.core import lsh as jlsh
from repro.core.buckets import partition_even as j_partition_even

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "geek_ref_dense")
CFG = dict(m=16, t=32, k_max=64, pair_cap=1 << 14)   # t = 32 ∤ n: ragged
GRID_X, GRID_A = 16.0, 64.0


@dataclasses.dataclass(frozen=True)
class GridLSHBucketer(japi.LSHBucketer):
    """``repro``'s bucketer with its drawn ``a`` rounded to a 1/64 grid.

    With x on a 1/16 grid too, every product and partial sum of ``x @ a``
    is exact in float32, whatever the summation order, so the QALSH ranks
    (and hence the tables and seeds) can be held bit for bit. Off the
    grid the two libraries' matmuls differ in the last ulps and swap
    near-equal ranks.
    """

    def buckets(self, kind, space, bkeys, cfg):
        (k_proj,) = bkeys
        a = jnp.round(jlsh.qalsh_projections(k_proj, space.shape[1], cfg.m)
                      * GRID_A) / GRID_A
        return j_partition_even(jlsh.qalsh_hash(space, a), cfg.t)


def _blobs(n=2000, d=32, k=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d))
    x = centers[rng.integers(0, k, n)] + 0.08 * rng.standard_normal((n, d))
    return (np.round(x * GRID_X) / GRID_X).astype(np.float32)


@pytest.fixture(scope="module")
def fits():
    """One reference fit and one port fit (CPU) on the same grid data,
    the port fed the reference's JAX-drawn ``a`` and SILK keys."""
    x = _blobs()
    key = jax.random.PRNGKey(5)
    jcfg = repro.GeekConfig(**CFG)
    jest = repro.GEEK(jcfg, bucketer=GridLSHBucketer())
    jmodel = jest.fit(repro.DenseData(x), key)
    a, keys = jax_draws(key, x.shape[1], jcfg)
    a = np.round(a * GRID_A) / GRID_A
    tb = InjectedBucketer(a=torch.from_numpy(a), table_keys=carrier(keys))
    test = rt.GEEK(rt.GeekConfig(**dataclasses.asdict(jcfg)), bucketer=tb,
                   device="cpu")
    tmodel = test.fit(rt.DenseData(x), 0)
    return dict(x=x, a=a, jest=jest, jmodel=jmodel, test=test, tmodel=tmodel,
                tb=tb, jcfg=jcfg)


def test_fit_tables_bit_identical(fits):
    x, cfg = fits["x"], fits["jcfg"]
    bkeys = japi.LSHBucketer().split_key("dense", jax.random.PRNGKey(5))[1]
    jt = GridLSHBucketer().buckets("dense", jnp.asarray(x), bkeys, cfg)
    tt = fits["tb"].buckets("dense", torch.from_numpy(x),
                            (torch.from_numpy(fits["a"]),), cfg)
    np.testing.assert_array_equal(tt.ids.numpy(), np.asarray(jt.ids))
    np.testing.assert_array_equal(tt.segments.numpy(), np.asarray(jt.segments))


def test_fit_seeds_bit_identical_and_centers_close(fits):
    jr, tr = fits["jest"].result_, fits["test"].result_
    assert int(tr.k_star) == int(jr.k_star) > 0
    assert int(tr.overflow) == int(jr.overflow) == 0
    for f in ("group", "id", "valid"):
        np.testing.assert_array_equal(getattr(tr.seeds, f).numpy(),
                                      np.asarray(getattr(jr.seeds, f)))
    np.testing.assert_array_equal(tr.center_valid.numpy(),
                                  np.asarray(jr.center_valid))
    # same members summed in the same order; 1e-6 covers a different
    # float32 association of the sum
    np.testing.assert_allclose(tr.centers.numpy(), np.asarray(jr.centers),
                               rtol=1e-6, atol=1e-6)


def test_fit_labels_match_except_near_ties(fits):
    jr, tr, x = fits["jest"].result_, fits["test"].result_, fits["x"]
    ties = assert_labels_match(x, np.asarray(jr.centers),
                               np.asarray(jr.center_valid),
                               np.asarray(jr.labels), tr.labels.numpy(),
                               "fit labels", max_ties=len(x) // 100)
    same = tr.labels.numpy() == np.asarray(jr.labels)
    # distances to the same center: float32 sqrt of a d² within 1e-5·scale
    np.testing.assert_allclose(tr.dists.numpy()[same],
                               np.asarray(jr.dists)[same], rtol=1e-4,
                               atol=1e-4)
    if ties == 0:
        np.testing.assert_allclose(tr.radius.numpy(), np.asarray(jr.radius),
                                   rtol=1e-4, atol=1e-4)


def test_predict_on_fit_rows_reproduces_fit_labels(fits):
    tr = fits["test"].result_
    labels, dists = rt.predict(fits["tmodel"], fits["x"])
    assert torch.equal(labels, tr.labels) and torch.equal(dists, tr.dists)
    labels2, _ = fits["test"].predict(rt.DenseData(torch.from_numpy(fits["x"])))
    assert torch.equal(labels2, tr.labels)


def test_reference_checkpoint_restores_in_port(fits, tmp_path):
    jmgr.save_model(str(tmp_path), fits["jmodel"])
    tmodel = rt.restore_model(str(tmp_path), device="cpu")
    jm = fits["jmodel"]
    np.testing.assert_array_equal(tmodel.centers.numpy(), np.asarray(jm.centers))
    np.testing.assert_array_equal(tmodel.center_valid.numpy(),
                                  np.asarray(jm.center_valid))
    assert int(tmodel.k_star) == int(jm.k_star)
    assert tmodel.static_meta() == jm.static_meta()
    q = _blobs(n=500, seed=1)
    jl, _ = repro.predict(jm, q)
    tl, _ = rt.predict(tmodel, q)
    assert_labels_match(q, np.asarray(jm.centers), np.asarray(jm.center_valid),
                        np.asarray(jl), tl.numpy(), "restored in port")


def test_port_checkpoint_restores_in_reference(fits, tmp_path):
    tm = fits["tmodel"]
    rt.save_model(str(tmp_path), tm)
    jm = jmgr.restore_model(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jm.centers), tm.centers.numpy())
    np.testing.assert_array_equal(np.asarray(jm.center_valid),
                                  tm.center_valid.numpy())
    np.testing.assert_array_equal(np.asarray(jm.radius), tm.radius.numpy())
    assert int(jm.k_star) == int(tm.k_star)
    assert jm.static_meta() == tm.static_meta()
    again = rt.restore_model(str(tmp_path), device="cpu")
    assert torch.equal(again.centers, tm.centers)
    assert torch.equal(rt.predict(again, fits["x"])[0],
                       fits["test"].result_.labels)


def test_fixture_is_self_consistent_under_reference():
    jm = jmgr.restore_model(os.path.join(FIXTURE, "ckpt"))
    q = np.load(os.path.join(FIXTURE, "queries.npy"))
    labels, dists = repro.predict(jm, q)
    assert jm.centers.shape == (64, 128) and q.shape == (256, 128)
    np.testing.assert_array_equal(np.asarray(labels),
                                  np.load(os.path.join(FIXTURE, "labels.npy")))
    np.testing.assert_array_equal(np.asarray(dists),
                                  np.load(os.path.join(FIXTURE, "dists.npy")))


def test_fixture_restores_in_port_and_predicts_reference_labels():
    tm = rt.restore_model(os.path.join(FIXTURE, "ckpt"), device="cpu")
    q = np.load(os.path.join(FIXTURE, "queries.npy"))
    want = np.load(os.path.join(FIXTURE, "labels.npy"))
    labels, dists = rt.predict(tm, q)
    assert_labels_match(q, tm.centers.numpy(), tm.center_valid.numpy(), want,
                        labels.numpy(), "fixture on CPU")
    same = labels.numpy() == want
    np.testing.assert_allclose(dists.numpy()[same],
                               np.load(os.path.join(FIXTURE, "dists.npy"))[same],
                               rtol=1e-4, atol=1e-4)


def _port_files():
    src = os.path.join(ROOT, "src", "repro_torch")
    tools = os.path.join(ROOT, "tools")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    out += [os.path.join(tools, f) for f in sorted(os.listdir(tools))
            if f.startswith("profile_torch_") and f.endswith(".py")]
    for d, _, files in os.walk(src):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_port_imports_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    grep = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_)|"
                      r"from repro\b(?!_))", re.M)
    for path in files:
        text = open(path).read()
        assert not grep.search(text), path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path} imports {name}"


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = rt.GeekConfig(**CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.GEEK(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.restore_model(os.path.join(FIXTURE, "ckpt"))
    rt.GEEK(cfg, device="cpu")   # the explicit CPU path still works
    lm = rt.get_arch("smollm_360m", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.init_params(lm, 0)
    keys = torch.zeros((16, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.OnlineKVCluster().start(keys, keys)
    params = rt.init_params(lm, 0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.clustered_decode(params, lm, tokens, 4)
    assert rt.clustered_decode(params, lm, tokens, 4, mode="exact",
                               device="cpu")["steps"] == 4


def test_streaming_batch_and_probed_modes_give_their_results(fits, tmp_path):
    """The modes that raised until they were ported now give their
    results: ``chunk=`` (with and without ``mesh=``) the in-core fit's,
    ``batch=`` the unbatched labels, ``probes=`` (with and without
    ``mesh=``) the probed labels of ``predict(probes=)``, which equal the
    exact ones wherever the exact argmin is among a row's candidates."""
    est, x, want = fits["test"], fits["x"], fits["test"].result_
    with single_rank_group(tmp_path):
        mesh = rt.make_mesh()
        for kw in (dict(chunk=128), dict(chunk=128, mesh=mesh)):
            streamed = rt.GEEK(est.cfg, bucketer=fits["tb"], device="cpu")
            model = streamed.fit(rt.DenseData(x), 0, **kw)
            got = streamed.result_
            for f in ("labels", "dists", "radius", "centers", "k_star"):
                assert torch.equal(getattr(got, f), getattr(want, f)), (kw, f)
            assert torch.equal(model.radius, fits["tmodel"].radius)
        exact, _ = est.predict(rt.DenseData(x))
        batched, _ = est.predict(rt.DenseData(x), batch=300)
        assert torch.equal(batched, exact)
        model = fits["tmodel"]
        probed, pd = rt.predict(model, x, probes=1)
        for kw in (dict(probes=1), dict(mesh=mesh, probes=1),
                   dict(batch=300, probes=1)):
            lab, dst = est.predict(rt.DenseData(x), **kw)
            assert torch.equal(lab, probed) and torch.equal(dst, pd), kw
    cand, mask = tmodel_mod.probe_candidates(model.center_index,
                                        torch.from_numpy(x), 1)
    mask &= model.center_valid[cand]
    hit = ((cand == exact[:, None].long()) & mask).any(1)
    assert hit.float().mean() > 0.5
    assert torch.equal(probed[hit], exact[hit])


def test_port_facade_draws_from_seed_deterministically():
    x = _blobs(n=600, seed=2)
    cfg = rt.GeekConfig(m=8, t=16, k_max=32, pair_cap=1 << 12)
    m1 = rt.GEEK(cfg, device="cpu").fit(rt.DenseData(x), 3)
    m2 = rt.GEEK(cfg, device="cpu").fit(
        x, torch.Generator().manual_seed(3))
    assert torch.equal(m1.centers, m2.centers) and int(m1.k_star) > 0

