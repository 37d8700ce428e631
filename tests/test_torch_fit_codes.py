"""The code-space slice: ``repro.GEEK.fit`` vs ``repro_torch.GEEK.fit`` on
heterogeneous rows (with and without categorical columns) and sparse
sets, predict, checkpoints both ways, and the reference's fixtures.

The port is handed the reference's JAX-drawn hash pairs
(``_torch_parity.jax_code_draws``). Every stage of these fits is
integer, and so are the Hamming distances (mismatch counts divided by d
in float32 the same way), so the two packages are held bit for bit:
seeds, k*, overflow, centers, labels, distances and radii. There is no
tolerance to state.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from _torch_parity import injected_code_bucketer, jax_code_draws, u32
from repro.checkpoint import manager as jmgr
from repro_torch.core import geek
from repro_torch.core import transform as tsf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CFG = dict(bucket_l=6, silk_l=3, k_max=32, pair_cap=1 << 13)
KINDS = ("hetero", "hetero_num", "sparse")


def _hetero(n, seed=0, k=8, card=12):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    x_num = (rng.standard_normal((k, 5))[lab]
             + 0.05 * rng.standard_normal((n, 5))).astype(np.float32)
    flip = rng.random((n, 4)) < 0.1
    x_cat = np.where(flip, rng.integers(0, card, (n, 4)),
                     rng.integers(0, card, (k, 4))[lab]).astype(np.int32)
    return x_num, x_cat


def _sparse(n, seed=0, k=8, nnz=20, universe=100_000):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    keep = rng.random((n, nnz)) < 0.9
    sets = np.where(keep, rng.integers(0, universe, (k, nnz))[lab],
                    rng.integers(0, universe, (n, nnz))).astype(np.int32)
    mask = np.ones((n, nnz), bool)
    mask[:, -4:] = rng.random((n, 4)) < 0.5            # ragged sets
    return sets, mask


def _data(kind, n, seed):
    """(repro dataset, repro_torch dataset, raw parts) for one kind."""
    if kind == "sparse":
        parts = _sparse(n, seed)
        return repro.SparseData(*parts), rt.SparseData(*parts), parts
    x_num, x_cat = _hetero(n, seed)
    parts = (x_num, None if kind == "hetero_num" else x_cat)
    return repro.HeteroData(*parts), rt.HeteroData(*parts), parts


@pytest.fixture(scope="module")
def fits():
    """Per kind: one reference fit and one port fit (CPU) on the same
    data, the port fed the reference's JAX-drawn keys."""
    out = {}
    for i, kind in enumerate(KINDS):
        jd, td, parts = _data(kind, 1500, i)
        key = jax.random.PRNGKey(7 + i)
        jcfg = repro.GeekConfig(**CFG)
        jest = repro.GEEK(jcfg)
        jmodel = jest.fit(jd, key)
        draws = jax_code_draws(key, "sparse" if kind == "sparse" else "hetero",
                               jcfg)
        test = rt.GEEK(rt.GeekConfig(**dataclasses.asdict(jcfg)),
                       bucketer=injected_code_bucketer(draws), device="cpu")
        tmodel = test.fit(td, 0)
        out[kind] = dict(jest=jest, jmodel=jmodel, test=test, tmodel=tmodel,
                         parts=parts, kind=kind)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_fit_bit_identical(fits, kind):
    f = fits[kind]
    jr, tr = f["jest"].result_, f["test"].result_
    jm, tm = f["jmodel"], f["tmodel"]
    assert int(tr.k_star) == int(jr.k_star) > 1
    assert int(tr.overflow) == int(jr.overflow) == 0
    assert (tm.metric, tm.impl, tm.code_bits) == (jm.metric, jm.impl,
                                                  jm.code_bits)
    assert tm.impl == {"hetero": "equality", "hetero_num": "packed",
                       "sparse": "packed"}[kind]
    for field in ("group", "id", "valid"):
        np.testing.assert_array_equal(getattr(tr.seeds, field).numpy(),
                                      np.asarray(getattr(jr.seeds, field)))
    assert tr.centers.dtype == torch.int32
    for field in ("centers", "center_valid", "labels", "dists", "radius"):
        np.testing.assert_array_equal(getattr(tr, field).numpy(),
                                      np.asarray(getattr(jr, field)))
    if tm.impl == "packed":
        np.testing.assert_array_equal(u32(tm.packed_centers),
                                      np.asarray(jm.packed_centers))


@pytest.mark.parametrize("kind", KINDS)
def test_predict_matches_fit_and_reference(fits, kind):
    f = fits[kind]
    tr = f["test"].result_
    codes = f["tmodel"].encode(*(None if p is None else torch.as_tensor(p)
                                 for p in f["parts"]))
    labels, dists = rt.predict(f["tmodel"], codes)
    assert torch.equal(labels, tr.labels) and torch.equal(dists, tr.dists)
    jd, td, _ = _data(kind, 300, 50 + KINDS.index(kind))   # fresh rows
    jl, jdist = f["jest"].predict(jd)
    tl, tdist = f["test"].predict(td)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))


@pytest.mark.parametrize("kind", ("hetero", "hetero_num"))
def test_hetero_checkpoint_port_to_reference(fits, kind, tmp_path):
    f = fits[kind]
    rt.save_model(str(tmp_path), f["tmodel"])
    jm = jmgr.restore_model(str(tmp_path))
    assert np.asarray(jm.centers).dtype == np.int32
    assert jm.static_meta() == f["jmodel"].static_meta()
    jd, _, _ = _data(kind, 300, 60)
    np.testing.assert_array_equal(
        np.asarray(f["jest"].predict(jd, model=jm)[0]),
        np.asarray(f["jest"].predict(jd)[0]))


@pytest.mark.parametrize("kind", ("hetero", "hetero_num"))
def test_hetero_checkpoint_reference_to_port(fits, kind, tmp_path):
    f = fits[kind]
    jmgr.save_model(str(tmp_path), f["jmodel"])
    tm = rt.restore_model(str(tmp_path), device="cpu")
    assert tm.centers.dtype == torch.int32
    np.testing.assert_array_equal(tm.centers.numpy(),
                                  np.asarray(f["jmodel"].centers))
    assert tm.static_meta() == f["jmodel"].static_meta()
    _, td, _ = _data(kind, 300, 61)
    est = rt.GEEK(rt.GeekConfig(), device="cpu")
    assert torch.equal(est.predict(td, model=tm)[0],
                       f["test"].predict(td)[0])


def test_sparse_checkpoint_rules(fits, tmp_path):
    """The port writes the reference's raw DOPH key (leaf
    ``transform_doph_key``) and reads it back; a reference checkpoint
    codes raw sets in the port to the reference's codes, labels and
    distances; an older port checkpoint holding the derived pair
    (``transform_doph_hash``) still restores and codes."""
    f = fits["sparse"]
    sets, mask = (torch.as_tensor(p) for p in f["parts"])
    rt.save_model(str(tmp_path / "port"), f["tmodel"])
    back = rt.restore_model(str(tmp_path / "port"), device="cpu")
    assert torch.equal(back.transform.doph_key, f["tmodel"].transform.doph_key)
    assert torch.equal(back.encode(sets, mask), f["tmodel"].encode(sets, mask))
    assert torch.equal(rt.predict(back, back.encode(sets, mask))[0],
                       f["test"].result_.labels)
    jmgr.save_model(str(tmp_path / "ref"), f["jmodel"])
    from_ref = rt.restore_model(str(tmp_path / "ref"), device="cpu")
    codes = from_ref.encode(sets, mask).numpy()
    np.testing.assert_array_equal(
        codes, np.asarray(f["jmodel"].encode(*f["parts"])))
    tl, td = rt.predict(from_ref, codes)
    jl, jdist = repro.predict(f["jmodel"], codes)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jdist))
    old = dataclasses.replace(f["tmodel"], transform=tsf.SparseTransform(
        None, f["tmodel"].transform.doph_m,
        doph_hash=f["tmodel"].transform.hash_pair()))
    rt.save_model(str(tmp_path / "old"), old)
    assert "transform_doph_hash" in json.load(open(
        tmp_path / "old" / "step_00000000" / "manifest.json"))["extra"]["fields"]
    legacy = rt.restore_model(str(tmp_path / "old"), device="cpu")
    assert legacy.transform.doph_key is None
    assert torch.equal(legacy.encode(sets, mask), f["tmodel"].encode(sets, mask))


def test_sparse_port_checkpoint_restores_in_reference_and_codes_sets(
        fits, tmp_path):
    """A port-written sparse checkpoint restores in ``repro``, which codes
    raw sets to the port's codes and predicts the port's labels. The sets
    are the fit's, at the shapes ``test_sparse_checkpoint_rules`` already
    compiles the reference's coding and predict for."""
    f = fits["sparse"]
    rt.save_model(str(tmp_path), f["tmodel"])
    jm = jmgr.restore_model(str(tmp_path))
    q_sets, q_mask = f["parts"]
    tcodes = f["tmodel"].encode(torch.as_tensor(q_sets), torch.as_tensor(q_mask))
    np.testing.assert_array_equal(np.asarray(jm.encode(q_sets, q_mask)),
                                  tcodes.numpy())
    jl, jdist = repro.predict(jm, jm.encode(q_sets, q_mask))
    tl, tdist = rt.predict(f["tmodel"], tcodes)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jdist), tdist.numpy())


def _fixture(name):
    path = os.path.join(DATA, name)
    load = {f[:-4]: np.load(os.path.join(path, f))
            for f in os.listdir(path) if f.endswith(".npy")}
    return os.path.join(path, "ckpt"), load


@pytest.mark.parametrize("name", ("geek_ref_hetero", "geek_ref_sparse"))
def test_code_fixture_restores_in_port_and_predicts_reference(name):
    ckpt, arr = _fixture(name)
    tm = rt.restore_model(ckpt, device="cpu")
    assert tm.metric == "hamming" and tm.centers.dtype == torch.int32
    if name == "geek_ref_hetero":
        labels, dists = rt.GEEK(rt.GeekConfig(), device="cpu").predict(
            rt.HeteroData(arr["x_num"], arr["x_cat"]), model=tm)
    else:
        labels, dists = rt.predict(tm, arr["codes"])
    np.testing.assert_array_equal(labels.numpy(), arr["labels"])
    np.testing.assert_array_equal(dists.numpy(), arr["dists"])


def test_sparse_fixture_reproduced_from_raw_sets():
    """The reference's sparse fixture, coded from its raw query sets by the
    port under the checkpoint's JAX key: its codes, labels, distances."""
    ckpt, arr = _fixture("geek_ref_sparse")
    tm = rt.restore_model(ckpt, device="cpu")
    np.testing.assert_array_equal(
        tm.encode(torch.as_tensor(arr["sets"]),
                  torch.as_tensor(arr["mask"])).numpy(), arr["codes"])
    labels, dists = rt.GEEK(rt.GeekConfig(), device="cpu").predict(
        rt.SparseData(arr["sets"], arr["mask"]), model=tm)
    np.testing.assert_array_equal(labels.numpy(), arr["labels"])
    np.testing.assert_array_equal(dists.numpy(), arr["dists"])


def test_port_facade_keeps_part_types_and_draws_from_seed():
    x_num, x_cat = _hetero(400, 3)
    cfg = rt.GeekConfig(**CFG)
    m1 = rt.GEEK(cfg, device="cpu").fit(rt.HeteroData(x_num, x_cat), 5)
    m2 = rt.GEEK(cfg, device="cpu").fit(
        rt.HeteroData(torch.from_numpy(x_num).double(),
                      torch.from_numpy(x_cat).long()),
        torch.Generator().manual_seed(5))
    assert m1.centers.dtype == torch.int32 and int(m1.k_star) > 0
    assert torch.equal(m1.centers, m2.centers)
    sets, mask = _sparse(400, 3)
    est = rt.GEEK(cfg, device="cpu")
    est.fit(rt.SparseData(sets, mask), 5)
    assert est.model_.transform.doph_key.shape == (2,)
    assert est.model_.transform.doph_hash is None
    assert torch.equal(
        geek.sparse_codes(torch.from_numpy(sets), torch.from_numpy(mask),
                          est.model_.transform.doph_key, cfg),
        est.model_.encode(torch.from_numpy(sets), torch.from_numpy(mask)))
    assert torch.equal(
        geek.hetero_codes(torch.from_numpy(x_num), torch.from_numpy(x_cat),
                          cfg.t_cat, transform=m1.transform),
        geek.hetero_codes(torch.from_numpy(x_num), torch.from_numpy(x_cat),
                          cfg.t_cat))
    with pytest.raises(TypeError, match="ambiguous"):
        est.fit((sets, mask), 5)
