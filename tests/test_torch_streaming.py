"""The port's out-of-core streaming fit (``GEEK.fit(..., chunk=)``,
``repro_torch.core.streaming``), on the CPU.

Inside the port, streamed fits with ``seed_cap=None`` equal the in-core
fit bit for bit (labels, dists, radius, centers, k*) for dense, hetero and
sparse data, at the reference's fixed cases (``tests/test_streaming.py``):
a ragged tail is padded to a whole chunk of sentinel rows, so every step
assigns ``chunk`` rows. The CPU's matrix product rounds a batch of fewer
than four rows differently from a larger one (by an ulp or so), so at
chunk sizes of 1-3 dense fits are held to the near-tie contract instead
(``_torch_parity.near_ties``, ties counted; squared distances within 1e-5
of ‖x‖² + max‖c‖²), as the reference's own chunk = 1 cases are a few ulps
off.

Against the reference's streamed fit, with the reference's draws
injected, the in-core parity contract holds: hetero and sparse fits are
integer and equal bit for bit (seeds, k*, centers, labels, dists, radius,
boundaries), with ``seed_cap=`` reservoirs (``Seeds.id`` maps to dataset
rows) and ``boundaries="exact"``; dense fits on rows whose products are
exact (``_torch_dist.exact_rows``) equal in k* and seeds, in labels but
at near-ties (counted), centers within 1e-5 and squared distances within
1e-5 of ‖x‖² + max‖c‖².
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from _torch_dist import exact_rows
from _torch_parity import (InjectedBucketer, carrier, injected_code_bucketer,
                           jax_code_draws, jax_draws, near_ties)
from repro_torch.core import streaming
from repro_torch.core.model import build_model, predict

CFG = dict(m=8, t=16, silk_l=3, delta=3, k_max=32, pair_cap=4096,
           assign_block=128, bucket_k=2, bucket_l=8, t_cat=8, doph_m=32)


def _fit(data, cfg=None, seed=1, **kw):
    """(result, model, estimator) of a CPU fit from ``seed``."""
    est = rt.GEEK(rt.GeekConfig(**(cfg or CFG)), device="cpu")
    model = est.fit(data, seed, **kw)
    return est.result_, model, est


def _dense(n, d=12, k=4, seed=0):
    rng = np.random.default_rng([seed, n, d])
    c = 3.0 * rng.standard_normal((k, d))
    return (c[rng.integers(0, k, n)] + 0.3 * rng.standard_normal((n, d))
            ).astype(np.float32)


def _hetero(n, seed=0, k=4):
    """5 numeric + 4 categorical columns: d = 9, at which XLA's multiply
    by 1/d and torch's division by d agree on every count."""
    rng = np.random.default_rng([seed, n])
    lab = rng.integers(0, k, n)
    x_num = (rng.standard_normal((k, 5))[lab]
             + 0.05 * rng.standard_normal((n, 5))).astype(np.float32)
    flip = rng.random((n, 4)) < 0.1
    x_cat = np.where(flip, rng.integers(0, 12, (n, 4)),
                     rng.integers(0, 12, (k, 4))[lab]).astype(np.int32)
    return x_num, x_cat


def _sparse(n, seed=0, k=4, nnz=16):
    rng = np.random.default_rng([seed, n])
    lab = rng.integers(0, k, n)
    keep = rng.random((n, nnz)) < 0.9
    sets = np.where(keep, rng.integers(0, 50_000, (k, nnz))[lab],
                    rng.integers(0, 50_000, (n, nnz))).astype(np.int32)
    mask = np.ones((n, nnz), bool)
    mask[:, -3:] = rng.random((n, 3)) < 0.5
    return sets, mask


def _assert_same(sres, smodel, res, model, what):
    for f in ("labels", "dists", "radius"):
        assert torch.equal(getattr(sres, f), getattr(res, f)), f"{what}: {f}"
    assert torch.equal(smodel.centers, model.centers), what
    assert torch.equal(smodel.radius, model.radius), what
    assert int(sres.k_star) == int(res.k_star), what


def _assert_dense_stream_matches(n, chunk, d=12):
    x = _dense(n, d)
    res, model, _ = _fit(rt.DenseData(x))
    sres, smodel, _ = _fit(rt.DenseData(x), chunk=chunk)
    _assert_same(sres, smodel, res, model, f"dense n={n} chunk={chunk}")


@pytest.mark.parametrize("n,chunk", [(33, 4), (150, 7), (256, 33),
                                     (400, 450), (257, 256), (399, 100)])
def test_streamed_fit_matches_incore_property(n, chunk):
    """Chunks smaller, larger and not dividing n: bit-identical labels,
    dists, radius and centers (fixed draws of the reference's property)."""
    _assert_dense_stream_matches(n, chunk)


@pytest.mark.parametrize("n,chunk", [(256, 64), (300, 77), (100, 256),
                                     (97, 96)])
def test_streamed_fit_matches_incore_fixed(n, chunk):
    _assert_dense_stream_matches(n, chunk)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_streamed_fit_few_row_chunks_hold_the_near_tie_contract(chunk):
    """Chunks of 1-3 rows round the CPU's product differently: labels
    equal but at near-ties (counted), squared distances within 1e-5 of
    the expansion's scale."""
    x = _dense(120)
    res, model, _ = _fit(rt.DenseData(x))
    sres, smodel, _ = _fit(rt.DenseData(x), chunk=chunk)
    assert torch.equal(smodel.centers, model.centers)
    assert int(sres.k_star) == int(res.k_star)
    ties, bad = near_ties(x, model.centers.numpy(),
                          model.center_valid.numpy(), res.labels.numpy(),
                          sres.labels.numpy())
    assert bad.size == 0
    if ties.size:
        print(f"chunk={chunk}: {ties.size} near-tie rows {ties.tolist()}")
    # squared distances within the near-tie scale ‖x‖² + max‖c‖²
    c = model.centers.numpy()[model.center_valid.numpy()]
    scale = (x * x).sum(1) + (c * c).sum(1).max()
    assert np.all(np.abs(sres.dists.numpy() ** 2 - res.dists.numpy() ** 2)
                  <= 1e-5 * scale)


def test_streamed_fit_accepts_iterator_and_rechunks():
    x = _dense(1000, 16)
    res, model, _ = _fit(rt.DenseData(x))
    pieces = (x[i:i + 370] for i in range(0, 1000, 370))
    sres, smodel, _ = _fit(rt.DenseData(chunks=pieces), chunk=256)
    _assert_same(sres, smodel, res, model, "iterator")


def test_streamed_fit_seed_cap_reservoir():
    """seed_cap caps discovery at a stride-sampled reservoir: labels are
    the nearest valid center, Seeds.id holds dataset rows (stride 4), and
    centroids rebuilt from those rows are the model's."""
    x = _dense(1200, 16, 6)
    sres, model, _ = _fit(rt.DenseData(x), chunk=256, seed_cap=300)
    assert sres.labels.shape == (1200,) and int(sres.k_star) >= 1
    d2 = ((x[:, None] - model.centers.numpy()[None]) ** 2).sum(-1)
    d2[:, ~model.center_valid.numpy()] = np.inf
    np.testing.assert_array_equal(sres.labels.numpy(), d2.argmin(1))
    ids, grp = sres.seeds.id.numpy(), sres.seeds.group.numpy()
    val = sres.seeds.valid.numpy()
    assert (ids[val] % 4 == 0).all()
    for j in np.unique(grp[val]):
        np.testing.assert_allclose(x[ids[val & (grp == j)]].mean(0),
                                   model.centers.numpy()[j], rtol=1e-5,
                                   atol=1e-5)


def test_streamed_fit_rejects_empty_and_bad_chunks():
    with pytest.raises(ValueError, match="empty"):
        _fit(rt.DenseData(chunks=iter([])), chunk=64)
    with pytest.raises(ValueError, match="positive"):
        _fit(rt.DenseData(np.zeros((10, 4), np.float32)), chunk=0)
    with pytest.raises(ValueError, match=r"\(m, d\)"):
        _fit(rt.DenseData(chunks=iter([np.zeros((4,), np.float32)])),
             chunk=4)
    with pytest.raises(ValueError, match="exactly one"):
        _fit(rt.DenseData(np.zeros((4, 2), np.float32), chunks=iter([])),
             chunk=4)
    with pytest.raises(ValueError, match="chunk="):
        rt.DenseData(chunks=iter([])).parts


def _assert_hetero_stream_matches(n, chunk, *, boundaries="reservoir",
                                  drop_cat=False):
    x_num, x_cat = _hetero(n, chunk)
    data = rt.HeteroData(x_num, None if drop_cat else x_cat)
    res, model, _ = _fit(data)
    sres, smodel, _ = _fit(data, chunk=chunk, boundaries=boundaries)
    _assert_same(sres, smodel, res, model, f"hetero n={n} chunk={chunk}")
    assert torch.equal(smodel.transform.discretizer.boundaries,
                       model.transform.discretizer.boundaries)


def _assert_sparse_stream_matches(n, chunk):
    data = rt.SparseData(*_sparse(n, chunk))
    res, model, _ = _fit(data)
    sres, smodel, _ = _fit(data, chunk=chunk)
    _assert_same(sres, smodel, res, model, f"sparse n={n} chunk={chunk}")


@pytest.mark.parametrize("n,chunk", [(33, 1), (120, 7), (250, 300),
                                     (201, 50)])
def test_streamed_hetero_matches_incore_property(n, chunk):
    """Integer codes: bit-identical at any chunk size, 1 included."""
    _assert_hetero_stream_matches(n, chunk)


@pytest.mark.parametrize("n,chunk", [(33, 1), (120, 7), (250, 300),
                                     (201, 50)])
def test_streamed_sparse_matches_incore_property(n, chunk):
    _assert_sparse_stream_matches(n, chunk)


@pytest.mark.parametrize("n,chunk", [(256, 64), (300, 77)])
def test_streamed_hetero_matches_incore_fixed(n, chunk):
    _assert_hetero_stream_matches(n, chunk)


@pytest.mark.parametrize("n,chunk", [(256, 64), (300, 77)])
def test_streamed_sparse_matches_incore_fixed(n, chunk):
    _assert_sparse_stream_matches(n, chunk)


def test_streamed_hetero_exact_boundaries_and_variants():
    _assert_hetero_stream_matches(300, 77, boundaries="exact")
    _assert_hetero_stream_matches(256, 60, drop_cat=True)
    _, x_cat = _hetero(256, 7)
    res, model, _ = _fit(rt.HeteroData(None, x_cat))
    sres, smodel, _ = _fit(rt.HeteroData(None, x_cat), chunk=100)
    _assert_same(sres, smodel, res, model, "categorical only")


def test_streamed_hetero_exact_boundaries_survive_seed_cap():
    x_num, x_cat = _hetero(600, 5)
    _, model, _ = _fit(rt.HeteroData(x_num, x_cat))
    _, smodel, _ = _fit(rt.HeteroData(x_num, x_cat), chunk=128, seed_cap=150,
                        boundaries="exact")
    assert torch.equal(smodel.transform.discretizer.boundaries,
                       model.transform.discretizer.boundaries)
    _, rmodel, _ = _fit(rt.HeteroData(x_num, x_cat), chunk=128, seed_cap=150)
    assert rmodel.transform.discretizer.boundaries.shape == \
        model.transform.discretizer.boundaries.shape


def test_streamed_hetero_iterator_input():
    x_num, x_cat = _hetero(500, 3)
    res, model, _ = _fit(rt.HeteroData(x_num, x_cat))
    pieces = ((x_num[i:i + 170], x_cat[i:i + 170])
              for i in range(0, 500, 170))
    sres, smodel, _ = _fit(rt.HeteroData(chunks=pieces), chunk=96)
    _assert_same(sres, smodel, res, model, "hetero iterator")


def test_streamed_sparse_seed_cap_reservoir():
    sets, mask = _sparse(400, 5)
    sres, model, _ = _fit(rt.SparseData(sets, mask), chunk=128, seed_cap=100)
    assert sres.labels.shape == (400,)
    ids, val = sres.seeds.id.numpy(), sres.seeds.valid.numpy()
    assert (ids[val] % 4 == 0).all()
    codes = model.encode(torch.from_numpy(sets),
                         torch.from_numpy(mask)).numpy()
    cents = model.centers.numpy()
    dist = (codes[:, None, :] != cents[None, :, :]).sum(-1)
    dist[:, ~model.center_valid.numpy()] = codes.shape[1] + 1
    np.testing.assert_array_equal(sres.labels.numpy(), dist.argmin(1))


def test_streamed_rejects_bad_tuple_inputs():
    with pytest.raises(ValueError, match="sparse"):
        _fit(rt.SparseData(np.zeros((8, 4), np.int32), None), chunk=4)
    with pytest.raises(ValueError, match="empty"):
        _fit(rt.HeteroData(chunks=iter([])), chunk=4)
    with pytest.raises(ValueError, match="disagree"):
        _fit(rt.HeteroData(np.zeros((8, 2), np.float32),
                           np.zeros((7, 2), np.int32)), chunk=4)
    with pytest.raises(ValueError, match="boundaries"):
        _fit(rt.HeteroData(np.zeros((8, 2), np.float32), None), chunk=4,
             boundaries="nope")
    with pytest.raises(ValueError, match="only applies to hetero"):
        _fit(rt.DenseData(np.zeros((8, 2), np.float32)), chunk=4,
             boundaries="exact")
    with pytest.raises(ValueError, match="seed_cap needs"):
        _fit(rt.DenseData(np.zeros((8, 2), np.float32)), seed_cap=4)


@pytest.mark.parametrize("n,chunk", [(1, 1), (57, 8), (300, 128),
                                     (129, 64)])
@pytest.mark.parametrize("impl", ["l2", "equality", "packed", "onehot"])
def test_chunked_predict_matches_full_property(impl, n, chunk):
    """``GEEK.predict(batch=)`` (sentinel-padded tail) equals one
    full-batch predict on every metric path."""
    rng = np.random.default_rng([n, chunk])
    k, d = 8, 16
    valid = np.arange(k) < k - 1
    if impl == "l2":
        c = rng.standard_normal((k, d)).astype(np.float32)
        x = rng.standard_normal((n, d)).astype(np.float32)
        kw = dict(metric="l2")
    else:
        c = rng.integers(0, 16, (k, d)).astype(np.int32)
        x = rng.integers(0, 16, (n, d)).astype(np.int32)
        kw = dict(metric="hamming", impl=impl, code_bits=4)
    model = build_model(torch.from_numpy(c), torch.from_numpy(valid),
                        torch.tensor(k - 1), torch.zeros(k), assign_block=64,
                        **kw)
    est = rt.GEEK(rt.GeekConfig(**CFG), device="cpu")
    full = predict(model, x)
    got = est.predict(rt.DenseData(x), model=model, batch=chunk)
    for g, w in zip(got, full):
        assert torch.equal(g, w)


def test_streaming_bit_identical_at_acceptance_shape():
    """n = 65,536, d = 64: chunk 8,192 (divides) and 7,000 (a ragged tail
    of 2,536 rows padded to a whole chunk)."""
    cfg = dict(CFG, k_max=256, pair_cap=1 << 15)
    x = _dense(65_536, 64, 32, seed=11)
    res, model, _ = _fit(rt.DenseData(x), cfg)
    for chunk in (8192, 7000):
        sres, smodel, _ = _fit(rt.DenseData(x), cfg, chunk=chunk)
        _assert_same(sres, smodel, res, model, f"chunk {chunk}")


def test_stride_sample_and_chunking_helpers():
    """Pieces re-cut to whole chunks; the strided reservoir and its rows."""
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    chunks, n, whole = streaming._collect(
        iter([x[:3], x[3:4], x[4:20]]), 1, 8)
    assert n == 20 and whole is None
    assert [c[0].shape[0] for c in chunks] == [8, 8, 4]
    sample, idx = streaming._stride_sample(chunks, n, 6, None)
    np.testing.assert_array_equal(idx, np.arange(0, 20, 4))
    np.testing.assert_array_equal(sample[0], x[::4])
    assert streaming._stride_sample(chunks, n, None, None)[1] is None
    with pytest.raises(ValueError, match="multiple of the mesh"):
        streaming._check_mesh_chunk(type("M", (), {"size": 3})(), 8)


# ---------------------------------------------------------------------------
# Against the reference's streamed fit, its draws injected
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,seed_cap,boundaries", [
    ("hetero", None, "reservoir"), ("hetero", 150, "reservoir"),
    ("hetero", 150, "exact"), ("sparse", None, "reservoir"),
    ("sparse", 100, "reservoir")])
def test_streamed_code_fit_matches_reference(kind, seed_cap, boundaries):
    parts = _hetero(600, 9) if kind == "hetero" else _sparse(600, 9)
    jdata = (repro.HeteroData if kind == "hetero" else repro.SparseData)(
        *parts)
    tdata = (rt.HeteroData if kind == "hetero" else rt.SparseData)(*parts)
    key = jax.random.PRNGKey(3)
    jcfg = repro.GeekConfig(**CFG)
    jest = repro.GEEK(jcfg)
    jmodel = jest.fit(jdata, key, chunk=128, seed_cap=seed_cap,
                      boundaries=boundaries)
    test = rt.GEEK(rt.GeekConfig(**dataclasses.asdict(jcfg)), device="cpu",
                   bucketer=injected_code_bucketer(
                       jax_code_draws(key, kind, jcfg)))
    tmodel = test.fit(tdata, 0, chunk=128, seed_cap=seed_cap,
                      boundaries=boundaries)
    jr, tr = jest.result_, test.result_
    assert int(tr.k_star) == int(jr.k_star) > 1
    v = np.asarray(jr.seeds.valid)
    np.testing.assert_array_equal(tr.seeds.valid.numpy(), v)
    for f in ("group", "id"):
        np.testing.assert_array_equal(getattr(tr.seeds, f).numpy()[v],
                                      np.asarray(getattr(jr.seeds, f))[v])
    for f in ("labels", "dists", "radius", "centers"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)))
    np.testing.assert_array_equal(tmodel.center_valid.numpy(),
                                  np.asarray(jmodel.center_valid))
    if kind == "hetero":
        np.testing.assert_array_equal(
            tmodel.transform.discretizer.boundaries.numpy(),
            np.asarray(jmodel.transform.discretizer.boundaries))


@pytest.mark.parametrize("seed_cap", [None, 500])
def test_streamed_dense_fit_matches_reference(seed_cap):
    x = exact_rows(2000, 32, 16, seed=4)
    key = jax.random.PRNGKey(2)
    jcfg = repro.GeekConfig(**dict(CFG, m=16, t=32, k_max=64,
                                   pair_cap=1 << 14))
    jest = repro.GEEK(jcfg)
    jest.fit(repro.DenseData(x), key, chunk=256, seed_cap=seed_cap)
    a, keys = jax_draws(key, x.shape[1], jcfg)
    test = rt.GEEK(rt.GeekConfig(**dataclasses.asdict(jcfg)), device="cpu",
                   bucketer=InjectedBucketer(a=torch.from_numpy(np.array(a)),
                                             table_keys=carrier(keys)))
    tmodel = test.fit(rt.DenseData(x), 0, chunk=256, seed_cap=seed_cap)
    jr, tr = jest.result_, test.result_
    assert int(tr.k_star) == int(jr.k_star) > 1
    v = np.asarray(jr.seeds.valid)
    np.testing.assert_array_equal(tr.seeds.valid.numpy(), v)
    np.testing.assert_array_equal(tr.seeds.id.numpy()[v],
                                  np.asarray(jr.seeds.id)[v])
    np.testing.assert_allclose(tr.centers.numpy(), np.asarray(jr.centers),
                               rtol=1e-5, atol=1e-5)
    ties, bad = near_ties(x, np.asarray(jr.centers),
                          np.asarray(jr.center_valid), np.asarray(jr.labels),
                          tr.labels.numpy())
    assert bad.size == 0
    if ties.size:   # rows of exact_rows often sit as near two centers
        print(f"dense seed_cap={seed_cap}: {ties.size} near-tie rows "
              f"{ties.tolist()[:20]}")
    c = np.asarray(jr.centers)[np.asarray(jr.center_valid)]
    scale = (x * x).sum(1) + (c * c).sum(1).max()
    same = tr.labels.numpy() == np.asarray(jr.labels)
    assert np.all(np.abs(tr.dists.numpy()[same] ** 2
                         - np.asarray(jr.dists)[same] ** 2)
                  <= 1e-5 * scale[same])
    assert tmodel.radius.shape == (jcfg.k_max,)
