"""The center index and probed predict: ``repro_torch`` against ``repro``'s
``core.model`` (``CenterIndex``, ``build_center_index``,
``probe_candidates``, ``predict_probed``, ``predict(probes=)``), on the
CPU, with the same numpy inputs handed to both packages.

Contract held here:

- **Hamming indexes are the reference's bits**: sorted keys and ids, the
  live count, the candidates and mask of every probe, and the probed
  labels, distances and empty flags, for the equality, packed and
  one-hot models, with 1 and 8 tables, duplicate centers and dead ones.
  The index draws its hash keys from the reference's fixed key
  (``utils.hashing.split`` + ``derive_hash_keys_from_key``).
- **l2 indexes on the reference's projection** (injected through
  ``model_from_numpy(index_hashers=)``): sorted keys within 1e-5 of the
  keys' scale (two float32 products of one dot, summed in another
  order), sorted ids equal except where two keys lie that close (counted
  and named); probed labels equal wherever both packages' windows hold
  the same centers, and the property below elsewhere.
- **The property, on the port's own index**: wherever a row's exact
  argmin is among its valid candidates, the probed label is the exact
  label (L2 labels compared but at near-ties, counted: the candidates'
  distances are a batched product, the exact ones the assignment's);
  rows with no valid candidate are flagged and get the exact result.
- **Serving surfaces and checkpoints**: ``GEEK.predict(probes=)`` with
  and without ``batch=``; save + restore rebuilds the same index; a
  model fitted and saved by ``repro`` and restored in the port predicts
  the reference's probed labels (Hamming; distances within one ulp,
  since XLA on the CPU multiplies the counts by the reciprocal of d
  where torch divides, which differ at d = 7) or holds the property
  (l2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from _torch_parity import near_ties
from repro.checkpoint import manager as jmgr
from repro.core import model as jm
from repro_torch.checkpoint import manager as tmgr
from repro_torch.core import model as tm

IMPLS = ("l2", "equality", "packed", "onehot")
HAMMING = ("equality", "packed", "onehot")


def _inputs(impl, n, seed=0, d=16, k=64, card=16, layout="plain"):
    """(centers, valid, queries) as numpy. ``layout="dup+dead"`` copies
    centers onto others and kills a scattered few; queries mix copies of
    centers with random rows, so matching signatures and empty windows
    both occur."""
    rng = np.random.default_rng([seed, k, d])
    valid = np.arange(k) < k - 2
    if impl == "l2":
        c = rng.standard_normal((k, d)).astype(np.float32)
        x = rng.standard_normal((n, d)).astype(np.float32)
    else:
        c = rng.integers(0, card, (k, d)).astype(np.int32)
        x = rng.integers(0, card, (n, d)).astype(np.int32)
        x[::3] = c[rng.integers(0, k, x[::3].shape[0])]
    if layout == "dup+dead":
        c[5], c[9], c[40] = c[3], c[3], c[17]
        valid[[3, 11, 17, 30]] = False
    return c, valid, x


def _models(impl, c, valid, *, tables=4, bucket=4, block=64):
    """The reference's model and the port's, built on the same centers;
    the port's l2 index on the reference's projection."""
    k = c.shape[0]
    kw = dict(assign_block=block, index_tables=tables, index_bucket=bucket)
    if impl == "l2":
        kw.update(metric="l2")
    else:
        kw.update(metric="hamming", impl=impl, code_bits=4)
    jmodel = jm.build_model(jnp.asarray(c), jnp.asarray(valid),
                            jnp.int32(int(valid.sum())),
                            jnp.zeros((k,), jnp.float32), **kw)
    arrays = {"centers": c, "center_valid": valid,
              "k_star": np.int32(valid.sum()),
              "radius": np.zeros((k,), np.float32)}
    hashers = None
    if impl == "l2":
        hashers = tuple(np.asarray(h) for h in jmodel.center_index.hashers)
    tmodel = tmgr.model_from_numpy(
        arrays, {"meta": jmodel.static_meta(), "transform": None}, "cpu",
        index_hashers=hashers)
    return jmodel, tmodel


def _own(impl, c, valid, **kw):
    """The port's model on its own index."""
    k = c.shape[0]
    kind = (dict(metric="l2") if impl == "l2"
            else dict(metric="hamming", impl=impl, code_bits=4))
    return tm.build_model(torch.from_numpy(c), torch.from_numpy(valid),
                          torch.tensor(int(valid.sum()), dtype=torch.int32),
                          torch.zeros(k), **kind, **kw)


def _hits(model, x, probes):
    """Rows whose exact argmin is among their valid candidates, and the
    exact labels and dists."""
    xt = torch.as_tensor(x)
    exact_lab, exact_d = tm.predict(model, xt)
    cand, mask = tm.probe_candidates(model.center_index,
                                     tm._as_queries(model, xt), probes)
    mask &= model.center_valid[cand]
    hit = ((cand == exact_lab[:, None].long()) & mask).any(1)
    return hit.numpy(), exact_lab.numpy(), exact_d.numpy()


def _assert_property(model, x, probes, what):
    """The probed label is the exact label wherever the exact argmin was
    probed (L2: but at near-ties, returned); empty rows are flagged with
    an infinite distance and patched with the exact result."""
    hit, exact_lab, exact_d = _hits(model, x, probes)
    lab, dst, empty = (t.numpy() for t in tm.predict_probed(model, x, probes))
    assert not (empty & hit).any(), what
    np.testing.assert_array_equal(dst[empty], np.inf)
    plab, pdst = (t.numpy() for t in tm.predict(model, x, probes=probes))
    np.testing.assert_array_equal(plab[empty], exact_lab[empty])
    np.testing.assert_array_equal(pdst[empty], exact_d[empty])
    if model.metric == "l2":
        ties, bad = near_ties(x[hit], model.centers.numpy(),
                              model.center_valid.numpy(), exact_lab[hit],
                              lab[hit])
        assert bad.size == 0, f"{what}: rows {bad[:10]}"
        np.testing.assert_allclose(dst[hit], exact_d[hit], rtol=1e-4,
                                   atol=1e-4)
        return ties.size
    np.testing.assert_array_equal(lab[hit], exact_lab[hit])
    np.testing.assert_array_equal(dst[hit], exact_d[hit])
    return 0


# ---------------------------------------------------------------------------
# Hamming: the reference's bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["plain", "dup+dead"])
@pytest.mark.parametrize("tables", [1, 8])
@pytest.mark.parametrize("impl", HAMMING)
def test_hamming_index_bit_identical_to_reference(impl, tables, layout):
    c, valid, x = _inputs(impl, 300, seed=tables, layout=layout)
    jmodel, _ = _models(impl, c, valid, tables=tables)
    tmodel = _own(impl, c, valid, assign_block=64, index_tables=tables,
                  index_bucket=4)   # its own draw: the reference's bits
    ji, ti = jmodel.center_index, tmodel.center_index
    np.testing.assert_array_equal(ti.sorted_keys.numpy(),
                                  np.asarray(ji.sorted_keys).astype(np.int64))
    np.testing.assert_array_equal(ti.sorted_ids.numpy(),
                                  np.asarray(ji.sorted_ids))
    assert int(ti.n_valid) == int(ji.n_valid) == int(valid.sum())
    empties = 0
    for p in (0, 1, 2):
        jc, jmask = jm.probe_candidates(ji, jnp.asarray(x), p)
        tc, tmask = tm.probe_candidates(ti, torch.from_numpy(x), p)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        want = jm.predict_probed(jmodel, jnp.asarray(x), p)
        got = tm.predict_probed(tmodel, torch.from_numpy(x), p)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        empties += int(got[2].sum())
        want = jm.predict(jmodel, jnp.asarray(x), probes=p)
        got = tm.predict(tmodel, torch.from_numpy(x), probes=p)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert empties > 0, "no empty probe: the fallback went untested"


def test_update_centers_rebuilds_the_reference_index():
    """A rebuilt Hamming index after moved centers and a new validity is
    the reference's rebuilt index, bit for bit."""
    c, valid, x = _inputs("packed", 100, seed=3)
    jmodel, _ = _models("packed", c, valid)
    tmodel = _own("packed", c, valid, assign_block=64, index_tables=4,
                  index_bucket=4)
    c2, valid2 = (c + 1) % 16, valid.copy()
    valid2[:5] = False
    jn = jm.update_centers(jmodel, jnp.asarray(c2),
                           center_valid=jnp.asarray(valid2),
                           k_star=jnp.int32(valid2.sum()), rebuild_index=True)
    tn = tm.update_centers(tmodel, torch.from_numpy(c2),
                           center_valid=torch.from_numpy(valid2),
                           k_star=torch.tensor(int(valid2.sum())),
                           rebuild_index=True)
    np.testing.assert_array_equal(tn.center_index.sorted_ids.numpy(),
                                  np.asarray(jn.center_index.sorted_ids))
    assert int(tn.k_star) == int(valid2.sum())
    for g, w in zip(tm.predict(tn, torch.from_numpy(x), probes=1),
                    jm.predict(jn, jnp.asarray(x), probes=1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    stale = tm.update_centers(tmodel, torch.from_numpy(c2))
    assert stale.center_index is tmodel.center_index


# ---------------------------------------------------------------------------
# l2: the reference's projection injected
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["plain", "dup+dead"])
@pytest.mark.parametrize("tables", [1, 8])
def test_l2_index_on_reference_projection(tables, layout):
    c, valid, x = _inputs("l2", 400, seed=tables, layout=layout)
    jmodel, tmodel = _models("l2", c, valid, tables=tables)
    ji, ti = jmodel.center_index, tmodel.center_index
    np.testing.assert_array_equal(ti.hashers[0].numpy(),
                                  np.asarray(ji.hashers[0]))
    jk, tk = np.asarray(ji.sorted_keys), ti.sorted_keys.numpy()
    finite = np.isfinite(jk)
    np.testing.assert_array_equal(np.isfinite(tk), finite)
    scale = np.abs(jk[finite]).max()
    np.testing.assert_allclose(tk[finite], jk[finite], rtol=0,
                               atol=1e-5 * scale)
    jid, tid = np.asarray(ji.sorted_ids), ti.sorted_ids.numpy()
    swapped = np.argwhere(jid != tid)
    for t, i in swapped:     # only keys within rounding may trade places
        keys = np.asarray(jmodel.centers)[[jid[t, i], tid[t, i]]] \
            @ np.asarray(ji.hashers[0])[:, t]
        assert abs(keys[0] - keys[1]) <= 1e-5 * scale, (t, i)
    if swapped.size:
        print(f"l2 index, {tables} tables: {len(swapped)} sorted positions "
              f"hold centers whose keys tie within rounding: "
              f"{swapped.tolist()[:10]}")
    for p in (0, 1, 2):
        jc, jmask = (np.asarray(a) for a in
                     jm.probe_candidates(ji, jnp.asarray(x), p))
        tc, tmask = (a.numpy() for a in
                     tm.probe_candidates(ti, torch.from_numpy(x), p))
        same = np.array([set(jc[r][jmask[r]]) == set(tc[r][tmask[r]])
                         for r in range(x.shape[0])])
        jl = np.asarray(jm.predict(jmodel, jnp.asarray(x), probes=p)[0])
        tl = tm.predict(tmodel, torch.from_numpy(x), probes=p)[0].numpy()
        ties, bad = near_ties(x[same], c, valid, jl[same], tl[same])
        assert bad.size == 0, f"probes={p}: rows {bad[:10]}"
        moved = np.flatnonzero(~same)
        if moved.size or ties.size:
            print(f"l2 probes={p}: {moved.size} rows whose windows differ "
                  f"{moved.tolist()[:10]}, {ties.size} near-ties")
        _assert_property(tmodel, x, p, f"l2 probes={p}")


# ---------------------------------------------------------------------------
# The port's own index: exact path, checkpoints, the property, fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_probes_none_bit_identical_incl_checkpoint(impl, tmp_path):
    """probes=None is the exact path; a restored model (index rebuilt from
    the centers) gives the same exact and probed outputs."""
    c, valid, x = _inputs(impl, 300)
    model = _own(impl, c, valid, assign_block=64, index_tables=4,
                 index_bucket=4)
    xt = torch.from_numpy(x)
    exact = tm.predict(model, xt)
    for g, w in zip(tm.predict(model, xt, probes=None), exact):
        assert torch.equal(g, w)
    probed = tm.predict(model, xt, probes=2)
    rt.save_model(str(tmp_path), model)
    back = rt.restore_model(str(tmp_path), device="cpu")
    assert (back.index_tables, back.index_bucket) == (4, 4)
    assert torch.equal(back.center_index.sorted_keys,
                       model.center_index.sorted_keys)
    assert torch.equal(back.center_index.sorted_ids,
                       model.center_index.sorted_ids)
    for a, b in zip(tm.predict(back, xt) + tm.predict(back, xt, probes=2),
                    exact + probed):
        assert torch.equal(a, b)


@pytest.mark.parametrize("probes", [0, 1, 2])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", [0, 3, 6])
def test_probed_label_matches_exact_when_argmin_in_probe_set(seed, impl,
                                                             probes):
    c, valid, x = _inputs(impl, 64, seed=seed)
    model = _own(impl, c, valid, assign_block=64, index_tables=4,
                 index_bucket=4)
    _assert_property(model, x, probes, f"{impl} seed {seed}")


def test_empty_probe_rows_fall_back_to_exact():
    """Hamming probes=0 on rows matching no center signature: every window
    is empty and predict patches every row with the exact scan."""
    c, valid, _ = _inputs("equality", 8)
    model = _own("equality", c, valid, assign_block=64, index_tables=4,
                 index_bucket=4)
    xq = torch.full((37, 16), 99, dtype=torch.int32)
    _, _, empty = tm.predict_probed(model, xq, 0)
    assert bool(empty.all())
    for g, w in zip(tm.predict(model, xq, probes=0), tm.predict(model, xq)):
        assert torch.equal(g, w)


def test_predict_probed_end_to_end_matches_exact_everywhere():
    """With the window as wide as k the probed path is the exact path."""
    c, valid, x = _inputs("l2", 500)
    model = _own("l2", c, valid, assign_block=64, index_tables=8,
                 index_bucket=64)
    xt = torch.from_numpy(x)
    ties, bad = near_ties(x, c, valid, tm.predict(model, xt)[0].numpy(),
                          tm.predict(model, xt, probes=0)[0].numpy())
    assert bad.size == 0 and ties.size <= 2


def test_probed_validation_errors():
    c, valid, x = _inputs("l2", 16)
    model = _own("l2", c, valid, index_tables=4, index_bucket=4)
    with pytest.raises(ValueError, match="probes"):
        tm.predict_probed(model, torch.from_numpy(x), -1)
    noidx = _own("l2", c, valid, index_tables=0)
    assert noidx.center_index is None
    with pytest.raises(ValueError, match="center index"):
        tm.predict(noidx, torch.from_numpy(x), probes=1)
    with pytest.raises(ValueError, match="expected"):
        tm.predict_probed(model, torch.from_numpy(x[:, :-1]), 1)


def test_probed_recall_on_sublinear_window():
    """A window narrower than k: recall against exact stays high on
    clustered queries and every row keeps a finite distance."""
    rng = np.random.default_rng(3)
    k, d = 256, 16
    centers = (8.0 * rng.standard_normal((k, d))).astype(np.float32)
    model = _own("l2", centers, np.ones(k, bool), assign_block=256,
                 index_tables=8, index_bucket=8)
    x = (centers[rng.integers(0, k, 2048)]
         + 0.05 * rng.standard_normal((2048, d))).astype(np.float32)
    lab0, _ = tm.predict(model, x)
    lab, dst = tm.predict(model, x, probes=2)
    assert float((lab == lab0).float().mean()) >= 0.95
    assert bool(torch.isfinite(dst).all())
    _assert_property(model, x, 2, "sub-linear")


def test_probed_recall_caveat_overlapping_clusters():
    """The reference's caveat on the reference's projection: centers in one
    dense ball defeat a narrow rank window (probes=1 recall < 0.6), and
    more probes bring it back (probes=8 >= 0.95)."""
    rng = np.random.default_rng(0)
    k, d, n = 256, 8, 600
    centers = (0.3 * rng.standard_normal((k, d))).astype(np.float32)
    _, model = _models("l2", centers, np.ones(k, bool), tables=4, bucket=4,
                       block=256)
    x = (0.3 * rng.standard_normal((n, d))).astype(np.float32)
    lab0, _ = tm.predict(model, x)

    def recall(p):
        return float((tm.predict(model, x, probes=p)[0] == lab0)
                     .float().mean())

    r1, r8 = recall(1), recall(8)
    assert r1 < 0.6 and r8 > r1 and r8 >= 0.95, (r1, r8)


# ---------------------------------------------------------------------------
# The facade and fits restored from the reference
# ---------------------------------------------------------------------------

CFG = dict(m=8, t=16, silk_l=3, delta=3, k_max=32, pair_cap=4096, t_cat=8,
           bucket_k=2, bucket_l=8)


def _blobs(n, d=16, k=8, seed=0):
    rng = np.random.default_rng(seed)
    c = 4.0 * rng.standard_normal((k, d))
    return (c[rng.integers(0, k, n)] + 0.3 * rng.standard_normal((n, d))
            ).astype(np.float32)


def _hetero(n, seed=0, k=8):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    x_num = (rng.standard_normal((k, 3))[lab]
             + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    x_cat = rng.integers(0, 12, (k, 4))[lab].astype(np.int32)
    return x_num, x_cat


def test_facade_probed_predict_dense_and_batched():
    x = _blobs(1200)
    est = rt.GEEK(rt.GeekConfig(**CFG), device="cpu")
    model = est.fit(rt.DenseData(x), 1)
    lab0, _ = est.predict(rt.DenseData(x))
    lab1, d1 = est.predict(rt.DenseData(x), probes=1)
    assert float((lab0 == lab1).float().mean()) >= 0.99
    lab2, d2 = est.predict(rt.DenseData(x), probes=1, batch=500)
    assert torch.equal(lab1, lab2) and torch.equal(d1, d2)
    _assert_property(model, x, 1, "fitted dense")


def test_facade_probed_predict_hetero():
    x_num, x_cat = _hetero(800)
    est = rt.GEEK(rt.GeekConfig(**CFG), device="cpu")
    est.fit(rt.HeteroData(x_num, x_cat), 1)
    lab0, d0 = est.predict(rt.HeteroData(x_num, x_cat))
    lab1, d1 = est.predict(rt.HeteroData(x_num, x_cat), probes=2)
    assert torch.equal(lab0, lab1) and torch.equal(d0, d1)


@pytest.mark.parametrize("kind", ["dense", "hetero", "sparse"])
def test_reference_fit_restored_in_port_predicts_probed(kind, tmp_path):
    """Fit in ``repro``, save, restore in the port, predict(probes=p):
    Hamming labels and distances equal the reference's probed predict;
    l2 (the port's own projection) holds the property."""
    key = jax.random.PRNGKey(1)
    jest = repro.GEEK(repro.GeekConfig(**CFG))
    test = rt.GEEK(rt.GeekConfig(**CFG), device="cpu")
    if kind == "dense":
        data, q = (_blobs(900),), (_blobs(300, seed=5),)
        jd, td = repro.DenseData, rt.DenseData
    elif kind == "hetero":
        data, q = _hetero(900), _hetero(300, seed=5)
        jd, td = repro.HeteroData, rt.HeteroData
    else:
        rng = np.random.default_rng(2)
        sets = rng.integers(0, 3000, (1200, 12)).astype(np.int32)
        sets[::2] = sets[1::2]
        mask = np.ones(sets.shape, bool)
        data, q = (sets[:900], mask[:900]), (sets[900:], mask[900:])
        jd, td = repro.SparseData, rt.SparseData
    jest.fit(jd(*data), key)
    jmgr.save_model(str(tmp_path), jest.model_)
    back = rt.restore_model(str(tmp_path), device="cpu")
    for p in (0, 1):
        jl, jdist = jest.predict(jd(*q), probes=p)
        tl, tdist = test.predict(td(*q), model=back, probes=p)
        if kind == "dense":
            _assert_property(back, q[0], p, f"restored dense probes={p}")
        else:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            # counts / d: XLA on the CPU multiplies by the reciprocal of d
            # (d = 7 here), torch divides: one ulp at most
            np.testing.assert_array_max_ulp(tdist.numpy(), np.asarray(jdist),
                                            maxulp=1)
    if kind != "dense":
        np.testing.assert_array_equal(
            back.center_index.sorted_ids.numpy(),
            np.asarray(jest.model_.center_index.sorted_ids))


def test_model_from_numpy_carries_hamming_hashers():
    """The reference's raw Hamming hashers, carried across, give the
    index the port draws itself."""
    c, valid, _ = _inputs("equality", 10)
    jmodel, _ = _models("equality", c, valid)
    arrays = {"centers": c, "center_valid": valid,
              "k_star": np.int32(valid.sum()),
              "radius": np.zeros(c.shape[0], np.float32)}
    meta = {"meta": jmodel.static_meta(), "transform": None}
    carried = tmgr.model_from_numpy(
        arrays, meta, "cpu",
        index_hashers=tuple(np.asarray(h)
                            for h in jmodel.center_index.hashers))
    own = tmgr.model_from_numpy(arrays, meta, "cpu")
    for a, b in zip(carried.center_index.hashers, own.center_index.hashers):
        assert torch.equal(a, b)
    assert torch.equal(carried.center_index.sorted_ids,
                       own.center_index.sorted_ids)
    assert dataclasses.replace(carried, center_index=None).center_index \
        is None
