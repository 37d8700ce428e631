"""The port's multi-device fits and serving on gloo ranks, against the
port's in-core fit and against ``repro``'s sharded code.

Four gloo ranks are spawned once for the whole module; ranks 0 and 1
also form a group of two, so one spawn serves g = 4 and g = 2 (g = 1
runs in this process), and every output the tests compare is computed
then (``_torch_dist.mesh_outputs``). The reference runs once,
in one subprocess with four forced CPU devices, beside them. Each spawn
and the subprocess have their own timeout.

- Sharded fits (dense, hetero, sparse; n = 1537, ragged at g = 2 and 4;
  sharded and gathered discovery; the narrow-int bucket-map wire) equal
  the port's in-core fit bit for bit: labels, dists, centers, seeds, k*,
  overflow, radius, as ``repro`` holds its own sharded fit.
- ``make_predict_sharded`` equals ``predict``, with ``probes=1`` too; a
  checkpoint of a sharded fit restores on every rank and serves the fit
  labels.
- The streaming fit with ``mesh=`` (``chunk=256``, a ragged tail) equals
  the in-core fit bit for bit on every rank.
- ``narrow_int_all_to_all`` equals the reference's on the same per-rank
  inputs, bit for bit. ``compressed_psum`` quantizes exactly as the
  reference does; the reference's compiler contracts the dequantizing
  multiply-adds into FMAs, so its reduced sums, and the residuals, differ
  in the last bit: the means are held within one int8 step of the
  reference's second quantization, the residuals within one ulp of 2|x|.
- The table-sync fit (``make_fit_dense``, the reference's draws
  injected) on rows whose products and sums are exact: k*, overflow,
  validity and labels bit for bit at g = 2 (and g = 1), centers bit for
  bit without compression and within 2 float32 ulps of their magnitude
  with it, squared radii within 1e-5 of the expansion's scale
  ‖x‖² + ‖c‖² (d² cancels, so a last-bit change in a center moves it).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch as rt
from _torch_dist import (KINDS, N_FIT, N_NEW, SHARD_CFG, SYNC_CFG, SYNC_RUNS,
                         blobs, collective_inputs, exact_rows, fit_outputs,
                         mesh_outputs, run_ranks, single_rank_group,
                         spawned_outputs)
from repro_torch.utils import compat

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
SPAWN_TIMEOUT = 300
REF_TIMEOUT = 300

# the reference's side, in one process with 4 forced CPU devices
REF_SCRIPT = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.core.distributed import make_fit_dense
    from repro.core.geek import GeekConfig
    from repro.distributed.compression import (compressed_psum,
                                               narrow_int_all_to_all)
    from repro.utils.compat import shard_map
    from _torch_dist import SYNC_CFG, SYNC_RUNS, collective_inputs, exact_rows
    out = {}
    x = exact_rows()
    names = ("labels", "centers", "valid", "k_star", "radius", "overflow")
    for g, runs in ((2, SYNC_RUNS), (1, ((2, False),))):
        mesh = Mesh(np.array(jax.devices()[:g]), ("data",))
        for s, c in runs:
            cfg = GeekConfig(**SYNC_CFG, refine_sweeps=s,
                             compress_collectives=c)
            xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
            res = make_fit_dense(mesh, cfg)(xs, jax.random.PRNGKey(1))
            for name, v in zip(names, res):
                out[f"sync{g}_{s}_{int(c)}_{name}"] = np.asarray(v)
    for g in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:g]), ("d",))
        xg, ints = collective_inputs(g)
        f = shard_map(lambda v: tuple(o[None] for o in compressed_psum(v[0], "d")),
                      mesh=mesh, in_specs=(P("d"),), out_specs=(P("d"), P("d")),
                      check_vma=False)
        mean, resid = jax.jit(f)(xg)
        out[f"psum_{g}_mean"], out[f"psum_{g}_resid"] = map(np.asarray, (mean, resid))
        for b, v in ints.items():
            f = shard_map(lambda v, b=b: narrow_int_all_to_all(
                              v[0], "d", 1 << b, split_axis=1, concat_axis=0)[None],
                          mesh=mesh, in_specs=(P("d"),), out_specs=P("d"),
                          check_vma=False)
            out[f"narrow_{g}_{b}"] = np.asarray(jax.jit(f)(v))
    np.savez(sys.argv[1], **out)
""")


def _reference_draws(cfg_kw):
    """The reference table-sync fit's draws for PRNGKey(1): (a, keys)."""
    import jax
    from repro.core import lsh
    from repro.utils.hashing import derive_hash_keys
    k_proj, k_silk = jax.random.split(jax.random.PRNGKey(1))
    d = exact_rows().shape[1]
    a = np.asarray(lsh.qalsh_projections(k_proj, d, cfg_kw["m"]))
    keys = np.asarray(derive_hash_keys(k_silk, (cfg_kw["silk_l"] + 1, 3)))
    return a, keys


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Every output the module compares (see the module docstring)."""
    tmp = str(tmp_path_factory.mktemp("torch_dist"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    ref_path = os.path.join(tmp, "reference.npz")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, ref_path],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        a, keys = _reference_draws(SYNC_CFG)
        sync = dict(x=exact_rows(), a=a, keys=keys)
        incore = {}
        for kind in KINDS:
            est, model, res = fit_outputs(SHARD_CFG, blobs(kind, N_FIT, 0),
                                          kind)
            fresh = rt.predict(model, model.encode(*(
                torch.as_tensor(p) for p in blobs(kind, N_NEW, 99))))
            res["predict_fresh"] = tuple(t.numpy() for t in fresh)
            res["predict_probed"] = tuple(t.numpy() for t in rt.predict(
                model, model.encode(*(torch.as_tensor(p) for p in blobs(
                    kind, N_NEW, 99))), probes=1))
            incore[kind] = res
        ranks = {}
        with single_rank_group(tmp):
            ranks[1] = [mesh_outputs(compat.make_mesh(), tmp, sync)]
            g1_runs = ranks[1][0]["sync"]
        sync_path = os.path.join(tmp, "sync.npz")
        np.savez(sync_path, **sync)
        spawned = run_ranks(spawned_outputs, 4, tmp, SPAWN_TIMEOUT,
                            ckpt_dir=tmp, sync_path=sync_path)
        ranks[2] = [out[2] for out in spawned[:2]]
        ranks[4] = [out[4] for out in spawned]
        _, err = proc.communicate(timeout=REF_TIMEOUT)
        assert proc.returncode == 0, err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    ref = dict(np.load(ref_path))
    return dict(incore=incore, ranks=ranks, ref=ref, g1_runs=g1_runs)


FIT_FIELDS = ("labels", "dists", "centers", "valid", "k_star", "overflow",
              "radius")


def _assert_same_fit(got, want, what):
    for f in FIT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what}: {f}")
    # seeds: the valid lanes, their groups and their global row ids
    np.testing.assert_array_equal(got["seed_valid"], want["seed_valid"])
    v = want["seed_valid"]
    for f in ("seed_group", "seed_id"):
        np.testing.assert_array_equal(got[f][v], want[f][v],
                                      err_msg=f"{what}: {f}")


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_fit_bit_identical_to_incore(outputs, kind, g):
    want = outputs["incore"][kind]
    assert 0 < want["k_star"] and want["overflow"] == 0
    for rank, out in enumerate(outputs["ranks"][g]):
        got = out[("sharded", kind)]
        assert got["impl"] == want["impl"]
        _assert_same_fit(got, want, f"{kind} g={g} rank {rank}")


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_gathered_discovery_bit_identical_to_incore(outputs, kind, g):
    _assert_same_fit(outputs["ranks"][g][0][("gathered", kind)],
                     outputs["incore"][kind], f"gathered {kind} g={g}")


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_compressed_wire_bit_identical_to_incore(outputs, kind, g):
    """compress_collectives narrows the bucket-map exchange (uint8 for the
    dense t = 32; 16 bits for the sparse cap n = 1537) losslessly."""
    _assert_same_fit(outputs["ranks"][g][0][("compress", kind)],
                     outputs["incore"][kind], f"compressed {kind} g={g}")


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_predict_sharded_equals_predict(outputs, kind, g):
    want_l, want_d = outputs["incore"][kind]["predict_fresh"]
    for out in outputs["ranks"][g]:
        res = out[("sharded", kind)]
        got_l, got_d = res["predict_fresh"]
        assert got_l.shape == (N_NEW,)
        np.testing.assert_array_equal(got_l, want_l)
        np.testing.assert_array_equal(got_d, want_d)
        np.testing.assert_array_equal(res["predict_facade"], want_l)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_predict_sharded_probed_equals_predict(outputs, kind, g):
    """make_predict_sharded(probes=1): each rank probes and patches its own
    rows; the gathered result is single-device predict(probes=1)'s."""
    want_l, want_d = outputs["incore"][kind]["predict_probed"]
    for out in outputs["ranks"][g]:
        got_l, got_d = out[("sharded", kind)]["predict_probed"]
        np.testing.assert_array_equal(got_l, want_l)
        np.testing.assert_array_equal(got_d, want_d)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_streamed_sharded_fit_bit_identical_to_incore(outputs, kind, g):
    """fit(chunk=, mesh=): each 256-row chunk (the last one ragged) split
    over the ranks equals the in-core fit bit for bit on every rank."""
    for rank, out in enumerate(outputs["ranks"][g]):
        _assert_same_fit(out[("streamed", kind)], outputs["incore"][kind],
                         f"streamed {kind} g={g} rank {rank}")


@pytest.mark.parametrize("g", [1, 2, 4])
def test_sharded_checkpoint_restores_and_serves(outputs, g):
    for kind in KINDS:
        for out in outputs["ranks"][g]:
            res = out[("sharded", kind)]
            np.testing.assert_array_equal(res["restored_fit"], res["labels"])


@pytest.mark.parametrize("g", [1, 2, 4])
def test_seed_cap_routes_to_gathered_discovery(outputs, g):
    """seed_cap below n falls back to gathered discovery on the strided
    reservoir with the reference's warning; seed ids stay real rows."""
    res = outputs["ranks"][g][0]["seed_cap"]
    assert any("seed_cap=500 subsamples" in w for w in res["warned"])
    ids = res["seed_id"][res["seed_valid"]]
    assert res["k_star"] > 0 and ids.min() >= 0 and ids.max() < N_FIT
    assert res["labels"].shape == (N_FIT,)


def _requantization_step(mean: np.ndarray, g: int) -> np.ndarray:
    """Per element, one int8 step of the reduced block it came from: the
    block's largest |value| is 127 steps (``quantize_int8``)."""
    flat = mean.reshape(-1)
    n, pad = flat.size, (-flat.size) % g
    blocks = np.abs(np.pad(flat, (0, pad))).reshape(g, -1)
    step = np.repeat(blocks.max(1) / 127.0, blocks.shape[1])[:n]
    return step.reshape(mean.shape)


@pytest.mark.parametrize("g", [2, 4])
def test_compressed_psum_matches_reference(outputs, g):
    ref = outputs["ref"]
    x, _ = collective_inputs(g)
    for rank, out in enumerate(outputs["ranks"][g]):
        mean, resid = out["compressed_psum"]
        want = ref[f"psum_{g}_mean"][rank]
        step = _requantization_step(want, g)
        assert np.all(np.abs(mean - want) <= step * (1 + 1e-6))
        # x − q·scale with and without an FMA: |q·scale| <= 2|x| when q != 0
        assert np.all(np.abs(resid - ref[f"psum_{g}_resid"][rank])
                      <= np.spacing(2 * np.abs(x[rank])))
        err = np.abs(mean - x.mean(0)).max() / np.abs(x.mean(0)).max()
        assert err < 0.05
        for tree_mean, leaf_mean in zip(out["psum_tree"], out["psum_leaves"]):
            np.testing.assert_array_equal(tree_mean, leaf_mean)
        np.testing.assert_array_equal(mean, outputs["ranks"][g][0][
            "compressed_psum"][0])


@pytest.mark.parametrize("bits", [8, 16, 20])
@pytest.mark.parametrize("g", [2, 4])
def test_narrow_int_all_to_all_matches_reference(outputs, g, bits):
    ref = outputs["ref"][f"narrow_{g}_{bits}"]
    for rank, out in enumerate(outputs["ranks"][g]):
        np.testing.assert_array_equal(out["narrow"][bits], ref[rank])


@pytest.mark.parametrize("run", SYNC_RUNS, ids=lambda r: str(r))
def test_table_sync_fit_matches_reference(outputs, run):
    ref = _reference_sync(outputs, 2, run)
    for rank, out in enumerate(outputs["ranks"][2]):
        got = out["sync"][run]
        assert got["k_star"] == int(ref["k_star"]) < SYNC_CFG["k_max"]
        assert got["overflow"] == int(ref["overflow"]) == 0
        np.testing.assert_array_equal(got["valid"], ref["valid"])
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        _assert_centers(got, ref, run[1])


def _reference_sync(outputs, g, run):
    """The reference's table-sync outputs at g devices for ``run``."""
    prefix = f"sync{g}_{run[0]}_{int(run[1])}_"
    return {k[len(prefix):]: v for k, v in outputs["ref"].items()
            if k.startswith(prefix)}


def _assert_centers(got, ref, compress):
    if compress:   # the int8 all-reduce rounds the sums: 2 ulps
        tol = 2 * np.spacing(np.abs(ref["centers"]).astype(np.float32))
        assert np.all(np.abs(got["centers"] - ref["centers"]) <= tol)
    else:
        np.testing.assert_array_equal(got["centers"], ref["centers"])
    # radii are square roots of d² = ‖x‖² − 2x·c + ‖c‖², which cancels:
    # d² is held within 1e-5 of the expansion's scale, as labels are
    # (_torch_parity.near_ties)
    x = exact_rows().astype(np.float64)
    c = ref["centers"][ref["valid"]].astype(np.float64)
    scale = (x * x).sum(1).max() + (c * c).sum(1).max()
    r2 = got["radius"].astype(np.float64) ** 2
    assert np.all(np.abs(r2 - ref["radius"].astype(np.float64) ** 2)
                  <= 1e-5 * scale)


def test_table_sync_fit_g1_in_process_matches_reference(outputs):
    """The port's table-sync fit on a one-rank group in this process, the
    reference's on one CPU device."""
    got = outputs["g1_runs"][(2, False)]
    ref = _reference_sync(outputs, 1, (2, False))
    assert got["k_star"] == int(ref["k_star"]) and got["overflow"] == 0
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    _assert_centers(got, ref, False)


def test_discovery_knob_and_mesh_checks(tmp_path):
    """The reference's discovery errors, seed_cap without a mesh, a mesh
    whose backend is not the device's (for the facade's fit, the
    table-sync fit and restore_model), and make_mesh without a process
    group."""
    x = blobs("dense", 200, 3)[0]
    est = rt.GEEK(rt.GeekConfig(**SHARD_CFG), device="cpu")
    with pytest.raises(ValueError, match="seed_cap needs"):
        est.fit(rt.DenseData(x), 0, seed_cap=100)
    with pytest.raises(RuntimeError, match="process group"):
        compat.make_mesh()
    with single_rank_group(tmp_path):
        mesh = compat.make_mesh()
        with pytest.raises(ValueError, match="discovery must be"):
            est.fit(rt.DenseData(x), 0, mesh=mesh, discovery="bogus")
        with pytest.raises(ValueError, match="requested explicitly"):
            est.fit(rt.DenseData(x), 0, mesh=mesh, discovery="sharded",
                    seed_cap=50)
        with pytest.raises(ValueError, match="mesh axis"):
            est.fit(rt.DenseData(x), 0, mesh=mesh, mesh_axis="model")
        with pytest.raises(ValueError, match="probes must be"):
            est.predict(rt.DenseData(x), model=est.fit(rt.DenseData(x), 0),
                        mesh=mesh, probes=-1)
        with pytest.raises(ValueError, match="only applies to hetero"):
            est.fit(rt.DenseData(x), 0, mesh=mesh, chunk=64,
                    boundaries="exact")

        class NcclMesh(compat.Mesh):
            backend = "nccl"

        with pytest.raises(ValueError, match="needs a gloo mesh"):
            est.fit(rt.DenseData(x), 0, mesh=NcclMesh())
        with pytest.raises(ValueError, match="needs a gloo mesh"):
            rt.make_fit_dense(NcclMesh(), rt.GeekConfig(**SYNC_CFG),
                              device="cpu")(exact_rows(400), 0)
        rt.save_model(str(tmp_path / "ckpt"), est.fit(rt.DenseData(x), 0))
        with pytest.raises(ValueError, match="needs a gloo mesh"):
            rt.restore_model(str(tmp_path / "ckpt"), mesh=NcclMesh(),
                             device="cpu")


def test_fit_sharded_with_seed_cap_covering_n_stays_sharded(tmp_path):
    """seed_cap >= n is full coverage: distributed discovery, no warning,
    the in-core fit's labels."""
    parts = blobs("hetero", 400, 5)
    _, _, want = fit_outputs(SHARD_CFG, parts, "hetero")
    with single_rank_group(tmp_path):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _, _, got = fit_outputs(SHARD_CFG, parts, "hetero",
                                    compat.make_mesh(), seed_cap=400)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["centers"], want["centers"])


def test_table_sync_draws_from_seed_alike_on_every_call(tmp_path):
    """Without injected arrays make_fit_dense draws a and the SILK keys
    from the seed: the same seed gives the same fit."""
    x = exact_rows(400)
    cfg = rt.GeekConfig(**SYNC_CFG, refine_sweeps=1)
    with single_rank_group(tmp_path):
        fit = rt.make_fit_dense(compat.make_mesh(), cfg, device="cpu")
        r1, r2 = fit(x, 5), fit(x, torch.Generator().manual_seed(5))
        assert int(r1.k_star) > 0
        assert torch.equal(r1.labels, r2.labels)
        assert torch.equal(r1.centers, r2.centers)
