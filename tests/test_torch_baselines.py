"""The §4.1 baselines (``repro_torch.core.baselines``) and the facade's
``KMeansPPSeeder`` / ``ScalableKMeansPPSeeder``, against ``repro``'s, on
the CPU.

The draws are the port's own (``torch.randperm``, ``torch.multinomial``),
so the two packages seed differently. What is held:

- **Deterministic parts on injected draws.** Initial centers drawn by the
  reference's own JAX key are handed to both packages:
  - k-modes (``_kmodes_iterate`` against the reference's ``kmodes`` on
    its own draw): labels, centers, validity, distances and radii bit for
    bit (integer sweeps; d = 8, 9, 16, where the reference's CPU division
    by d is exact);
  - Lloyd (``_lloyd_iterate``, from the reference's k-means++ seeds):
    labels equal but at near-ties, counted and named
    (``_torch_parity.near_ties``), centers within 1e-5 (the sums are
    added in another order);
  - the one pass of ``seed_then_assign`` on the reference's seeds: labels
    equal but at near-ties;
  - in both, squared distances within 1e-5 of the expansion's scale
    ‖x‖² + max‖c‖²;
  - the k-means‖ candidate weights (``_candidate_weights``) on injected
    candidate indices, duplicates included, bit for bit (integer counts;
    integer-valued rows, so every distance is exact and ties break on the
    first index in both).
- **The draws, statistically**, each with its tolerance: on well
  separated blobs k-means++ and k-means‖ put one seed in every blob (a
  draw inside a covered blob has probability below 1e-9 here); over 16
  seeds the mean inertia of each method is within 10 % of the
  reference's over 16 keys; an all-zero D² vector draws row 0 as the
  reference does; more than 2**24 rows raise a named error.
- **The facade contract**: ``GEEK(cfg, seeder=KMeansPPSeeder(k))`` (and
  ``ScalableKMeansPPSeeder``) fitted from a seed equals
  ``seed_then_assign`` from the same seed bit for bit: labels,
  distances, centers (the seed rows themselves). The reference's own
  test of this is unsteady; this one runs the same CPU path twice.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from _torch_dist import single_rank_group
from _torch_parity import assert_labels_match
from repro.core import assign as jassign
from repro.core import baselines as jb
from repro_torch.core import baselines as tb

torch.set_num_threads(1)

CFG = rt.GeekConfig(m=8, t=16, silk_l=3, delta=3, k_max=64, pair_cap=4096)


def _blobs(n, d, k, seed, spread=0.05, scale=1.0):
    """(x float32 (n, d), true labels) of k Gaussian blobs."""
    rng = np.random.default_rng([seed, n, d, k])
    c = rng.standard_normal((k, d)) * scale
    lab = rng.integers(0, k, n)
    x = c[lab] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32), lab


def _assert_d2_close(x, centers, got, want, what):
    """Distances of the expansion ‖x‖² − 2x·c + ‖c‖²: their squares agree
    within 1e-5 of the expansion's scale ‖x‖² + max‖c‖² (it cancels, so a
    small distance carries the rounding of the large terms)."""
    scale = (x.astype(np.float64) ** 2).sum(1) + (
        np.asarray(centers, np.float64) ** 2).sum(1).max()
    err = np.abs(np.asarray(got, np.float64) ** 2
                 - np.asarray(want, np.float64) ** 2)
    assert (err <= 1e-5 * scale).all(), f"{what}: d² off by {err.max()}"


def _codes(n, d, k, seed, card=6):
    """Categorical codes around k modes, 15 % of cells resampled."""
    rng = np.random.default_rng([seed, n, d, k])
    modes = rng.integers(0, card, (k, d))
    lab = rng.integers(0, k, n)
    noise = rng.random((n, d)) < 0.15
    return np.where(noise, rng.integers(0, card, (n, d)),
                    modes[lab]).astype(np.int32)


# ---------------------------------------------------------------------------
# Deterministic parts on the reference's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,k,iters", [(1200, 8, 10, 10), (1500, 9, 24, 10),
                                         (900, 16, 7, 5), (4500, 9, 16, 3)])
def test_kmodes_iterate_is_the_references_bit_for_bit(n, d, k, iters):
    codes = _codes(n, d, k, seed=k)
    key = jax.random.PRNGKey(k)
    ref = jb.kmodes(jnp.asarray(codes), k, key, iters=iters)
    # the reference's own draw, injected into the port
    idx = np.asarray(jax.random.choice(key, n, (k,), replace=False))
    got = tb._kmodes_iterate(torch.from_numpy(codes),
                             torch.from_numpy(codes[idx]), iters)
    for name in ("labels", "centers", "center_valid", "dists", "radius"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.iters == iters == int(ref.iters)


@pytest.mark.parametrize("n,d,blobs,k,iters", [
    (2000, 16, 12, 12, 10), (1500, 32, 20, 20, 5), (800, 7, 5, 5, 8),
    (2400, 8, 16, 10, 10)])
def test_lloyd_iterate_matches_the_reference(n, d, blobs, k, iters):
    """From the reference's k-means++ seeds on separated blobs: no row
    lies within rounding of a bisector, so no near-tie flip moves a
    center, and the centers differ only by the order of their sums."""
    x, _ = _blobs(n, d, blobs, seed=3)
    c0 = np.asarray(jb.kmeanspp_seeds(jnp.asarray(x), k,
                                      jax.random.PRNGKey(n)))
    ref = jb._lloyd_iterate(jnp.asarray(x), jnp.asarray(c0), iters, 4096)
    got = tb._lloyd_iterate(torch.from_numpy(x), torch.from_numpy(c0.copy()),
                            iters)
    np.testing.assert_array_equal(got.center_valid.numpy(),
                                  np.asarray(ref.center_valid))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               rtol=0, atol=1e-5)
    assert_labels_match(x, np.asarray(ref.centers),
                        np.asarray(ref.center_valid), np.asarray(ref.labels),
                        got.labels.numpy(), f"lloyd ({n},{d},{k})")
    _assert_d2_close(x, np.asarray(ref.centers), got.dists.numpy(),
                     np.asarray(ref.dists), "lloyd")


@pytest.mark.parametrize("method", ["kmeans++", "scalable-kmeans++",
                                    "random"])
def test_seed_then_assign_pass_on_the_references_seeds(method):
    x, _ = _blobs(1800, 12, 9, seed=5, spread=0.3)
    ref = jb.seed_then_assign(jnp.asarray(x), 16, jax.random.PRNGKey(2),
                              method=method)
    centers = torch.from_numpy(np.array(ref.centers))
    got = tb._one_pass(torch.from_numpy(x), centers,
                       torch.ones(16, dtype=torch.bool), 4096, 0)
    assert_labels_match(x, np.asarray(ref.centers), np.ones(16, bool),
                        np.asarray(ref.labels), got.labels.numpy(),
                        f"seed_then_assign {method}")
    _assert_d2_close(x, np.asarray(ref.centers), got.dists.numpy(),
                     np.asarray(ref.dists), method)
    assert got.iters == int(ref.iters) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_weights_are_the_references_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (1500, 6)).astype(np.float32)  # exact distances
    cand = rng.integers(0, 1500, 200)
    cand[::7] = cand[0]                          # duplicates weigh 0
    nearest, _ = jassign.assign_l2(jnp.asarray(x), jnp.asarray(x[cand]),
                                   jnp.ones((cand.size,), bool))
    want = jax.ops.segment_sum(jnp.ones((1500,), jnp.int32), nearest,
                               num_segments=cand.size)
    got = tb._candidate_weights(torch.from_numpy(x), torch.from_numpy(cand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got.sum()) == 1500


# ---------------------------------------------------------------------------
# The draws, statistically
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["kmeans++", "scalable-kmeans++"])
@pytest.mark.parametrize("seed", range(4))
def test_one_seed_per_well_separated_blob(method, seed):
    """Blobs 100 apart with spread 0.01: the D² mass inside the covered
    blobs is below 1e-9 of the total, so every seed lands in its own
    blob."""
    x, lab = _blobs(3000, 4, 10, seed=7, spread=0.01, scale=100.0)
    res = tb.seed_then_assign(torch.from_numpy(x), 10, seed, method=method)
    idx = res.labels.numpy()
    # each seed's blob (a center is a data row, so its nearest row's blob)
    seeds_blob = lab[np.argmin(((x[:, None] - res.centers.numpy()[None])
                                ** 2).sum(-1), axis=0)]
    assert sorted(seeds_blob.tolist()) == list(range(10))
    # and the one pass puts every blob on one label
    for b in range(10):
        assert np.unique(idx[lab == b]).size == 1


@pytest.mark.parametrize("method", ["kmeans++", "scalable-kmeans++",
                                    "random"])
def test_mean_inertia_within_10_percent_of_the_reference(method):
    """16 seeds against 16 keys on overlapping blobs (k below the true
    count, so the inertia depends on the draw): the means differ by less
    than 10 %."""
    x, _ = _blobs(2000, 8, 24, seed=11, spread=0.5)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    port = [float((tb.seed_then_assign(xt, 16, s, method=method).dists ** 2)
                  .mean()) for s in range(16)]
    ref = [float(jnp.mean(jb.seed_then_assign(
        xj, 16, jax.random.PRNGKey(s), method=method).dists ** 2))
        for s in range(16)]
    assert abs(np.mean(port) / np.mean(ref) - 1.0) < 0.10, (port, ref)


def test_zero_d2_draws_row_zero_as_the_reference_does():
    x = np.ones((50, 3), np.float32)           # every row is every seed
    ref = np.asarray(jb.kmeanspp_indices(jnp.asarray(x), 5,
                                         jax.random.PRNGKey(0)))
    got = tb.kmeanspp_indices(torch.from_numpy(x), 5, 0).numpy()
    assert (ref[1:] == 0).all() and (got[1:] == 0).all()
    assert got.dtype == np.int32


def test_too_many_rows_for_multinomial_raise_a_named_error():
    x = torch.zeros(((1 << 24) + 1, 1))
    with pytest.raises(tb.TooManyCategoriesError, match="2\\*\\*24"):
        tb.kmeanspp_indices(x, 2, 0)
    with pytest.raises(tb.TooManyCategoriesError):
        tb.scalable_kmeanspp_indices(x, 2, 0)


def test_lloyd_sampled_and_kmodes_entry_points():
    x, _ = _blobs(3000, 8, 6, seed=1)
    xt = torch.from_numpy(x)
    for res in (tb.lloyd(xt, 6, 0, iters=5),
                tb.lloyd(xt, 6, 0, iters=5, init="kmeans++"),
                tb.sampled_kmeans(xt, 6, 0, iters=5, sample_per_k=64)):
        assert res.labels.shape == (3000,) and res.labels.dtype == torch.int32
        assert bool(torch.isfinite(res.dists).all())
        assert res.radius.shape == (6,)
    with pytest.raises(ValueError):
        tb.lloyd(xt, 6, 0, init="furthest")
    with pytest.raises(ValueError):
        tb.seed_then_assign(xt, 6, 0, method="furthest")
    codes = torch.from_numpy(_codes(600, 9, 4, 0))
    res = tb.kmodes(codes, 4, torch.Generator().manual_seed(3))
    assert res.centers.dtype == torch.int32 and res.iters == 10


# ---------------------------------------------------------------------------
# The facade's seeders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeder,method", [
    (rt.KMeansPPSeeder, "kmeans++"),
    (rt.ScalableKMeansPPSeeder, "scalable-kmeans++")])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_seeder_through_geek_equals_seed_then_assign(seeder, method, seed):
    x, _ = _blobs(1500, 16, 12, seed=seed, spread=0.2)
    est = rt.GEEK(CFG, seeder=seeder(16), device="cpu")
    model = est.fit(rt.DenseData(x), seed)
    base = tb.seed_then_assign(torch.from_numpy(x), 16, seed, method=method)
    res = est.result_
    assert torch.equal(res.labels, base.labels)
    assert torch.equal(res.dists, base.dists)
    assert torch.equal(model.centers[:16], base.centers)
    assert int(res.k_star) == 16 and not bool(model.center_valid[16:].any())
    assert model.seeder_id == method
    # seeds are data rows: singleton groups, centers are the rows
    ids = res.seeds.id[res.seeds.valid].long()
    assert torch.equal(model.centers[:16], torch.from_numpy(x)[ids])


def test_seeders_refuse_code_spaces_and_oversized_k():
    rng = np.random.default_rng(0)
    data = rt.HeteroData(rng.standard_normal((200, 3)).astype(np.float32),
                         rng.integers(0, 4, (200, 2)))
    with pytest.raises(ValueError, match="supports metrics"):
        rt.GEEK(CFG, seeder=rt.KMeansPPSeeder(4), device="cpu").fit(data, 0)
    x, _ = _blobs(300, 4, 3, seed=0)
    with pytest.raises(ValueError, match="exceeds GeekConfig.k_max"):
        rt.GEEK(CFG, seeder=rt.KMeansPPSeeder(65), device="cpu").fit(x, 0)


def test_sharded_fit_with_a_baseline_seeder_falls_back_to_gathered(tmp_path):
    """``mesh=`` with a seeder that takes no bucket tables: the reference's
    warning, or its error for an explicit ``discovery="sharded"``; the
    gathered fit is the in-core fit."""
    x, _ = _blobs(600, 8, 5, seed=2)
    est = rt.GEEK(CFG, seeder=rt.KMeansPPSeeder(8), device="cpu")
    want = est.fit(rt.DenseData(x), 4)
    want_labels = est.result_.labels
    with single_rank_group(tmp_path):
        mesh = rt.make_mesh()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = est.fit(rt.DenseData(x), 4, mesh=mesh)
        got_labels = est.result_.labels
        with pytest.raises(ValueError, match="discovery='sharded' was "
                                             "requested explicitly"):
            est.fit(rt.DenseData(x), 4, mesh=mesh, discovery="sharded")
    msgs = [str(w.message) for w in caught]
    assert any("seeder 'kmeans++' does not consume distributed bucket "
               "tables" in m for m in msgs), msgs
    assert torch.equal(got.centers, want.centers)
    assert torch.equal(got_labels, want_labels)
