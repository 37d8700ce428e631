"""The port's centers, assignment and L2 kernel path against ``repro``.

The reference's Pallas L2 module does not import on the installed JAX,
so its oracles are ``repro.kernels.ref`` and ``repro.core.assign``.
Float stages are held within stated tolerances; labels are equal except
at near-ties, which are counted and named.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (DEAD_TILE_LAYOUTS, assert_labels_match,
                           dead_tile_layout)
from repro.core import assign as ja
from repro.core import silk as js
from repro.kernels import ref as jref
from repro_torch.core import assign as ta
from repro_torch.core import silk as ts
from repro_torch.kernels import distance_argmin as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the shapes of tests/test_kernels.py's L2 sweep
SHAPES = [(64, 8, 16), (130, 33, 70), (257, 128, 128), (100, 5, 960)]


def _l2_inputs(n, k, d, seed=0):
    rng = np.random.default_rng(seed + n + k + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    valid = np.arange(k) % 7 != 3
    return x, c, valid


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_l2_plain_matches_reference(n, k, d):
    x, c, valid = _l2_inputs(n, k, d)
    jl, jd = jref.distance_argmin_l2_ref(jnp.asarray(x), jnp.asarray(c),
                                         jnp.asarray(valid))
    al, ad = ja.assign_l2(jnp.asarray(x), jnp.asarray(c), jnp.asarray(valid),
                          block=64)
    tx, tc, tv = map(torch.from_numpy, (x, c, valid))
    rl, rd = tref.distance_argmin_l2_ref(tx, tc, tv)
    ol, od = tops.distance_argmin_l2(tx, tc, tv, block=64)
    for lab, dist, what in ((rl, rd, "ref"), (ol, od, "ops/assign_l2")):
        assert lab.dtype == torch.int32
        assert_labels_match(x, c, valid, np.asarray(jl), lab.numpy(),
                            f"{what} vs repro ref {n}x{k}x{d}")
        assert_labels_match(x, c, valid, np.asarray(al), lab.numpy(),
                            f"{what} vs repro assign_l2 {n}x{k}x{d}")
        # d² in float32 from another summation order: within 1e-5 of the
        # expansion's scale ‖x‖² + ‖c‖² (see _torch_parity.near_ties)
        scale = (x * x).sum(1) + (c[valid] ** 2).sum(1).max()
        assert np.all(np.abs(dist.numpy() - np.asarray(jd)) <= 1e-5 * scale)


def test_l2_plain_bf16_inputs_cast_to_f32():
    x, c, valid = _l2_inputs(64, 8, 16)
    tx, tc = torch.from_numpy(x).bfloat16(), torch.from_numpy(c).bfloat16()
    rl, rd = tref.distance_argmin_l2_ref(tx, tc, torch.from_numpy(valid))
    jl, jd = jref.distance_argmin_l2_ref(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(c, jnp.bfloat16),
                                         jnp.asarray(valid))
    xf, cf = tx.float().numpy(), tc.float().numpy()
    assert_labels_match(xf, cf, valid, np.asarray(jl), rl.numpy(), "bf16")
    np.testing.assert_allclose(rd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)


def test_l2_no_valid_center_gives_label0_and_f32max():
    x, c, _ = _l2_inputs(10, 4, 8)
    none = np.zeros(4, bool)
    lab, d2 = tops.distance_argmin_l2(torch.from_numpy(x), torch.from_numpy(c),
                                      torch.from_numpy(none))
    jl, jd = jref.distance_argmin_l2_ref(jnp.asarray(x), jnp.asarray(c),
                                         jnp.asarray(none))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd))
    assert float(d2[0]) == np.finfo(np.float32).max and int(lab.max()) == 0


@pytest.mark.parametrize("layout", list(DEAD_TILE_LAYOUTS))
def test_l2_plain_matches_reference_on_dead_tile_layouts(layout):
    """The layouts the kernel's dead-tile skipping must keep (live centers
    as a prefix, dead tiles first or between live ones, every center dead,
    k not a multiple of the 64-center tile), at n not a multiple of the
    kernel's 128 rows: the plain versions against ``repro``'s."""
    x, c, valid = dead_tile_layout(layout, 300, 24)
    jl, jd = jref.distance_argmin_l2_ref(jnp.asarray(x), jnp.asarray(c),
                                         jnp.asarray(valid))
    jl, jd = np.asarray(jl), np.asarray(jd)
    tx, tc, tv = map(torch.from_numpy, (x, c, valid))
    for lab, dist in (tref.distance_argmin_l2_ref(tx, tc, tv),
                      tops.distance_argmin_l2(tx, tc, tv, block=64)):
        if not valid.any():
            # label 0 and float32 max everywhere, exactly
            np.testing.assert_array_equal(lab.numpy(), jl)
            np.testing.assert_array_equal(dist.numpy(), jd)
            assert int(lab.max()) == 0
            assert np.all(dist.numpy() == np.finfo(np.float32).max)
            continue
        assert_labels_match(x, c, valid, jl, lab.numpy(), layout)
        assert valid[lab.numpy()].all()
        scale = (x * x).sum(1) + (c[valid] ** 2).sum(1).max()
        assert np.all(np.abs(dist.numpy() - jd) <= 1e-5 * scale)


def _seeds(rng, C, k_max, n):
    group = rng.integers(-1, k_max, C).astype(np.int32)
    valid = group >= 0
    ids = rng.integers(0, n, C).astype(np.int32)
    return (js.Seeds(jnp.asarray(group), jnp.asarray(ids), jnp.asarray(valid),
                     jnp.int32(k_max), k_max),
            ts.Seeds(torch.from_numpy(group), torch.from_numpy(ids),
                     torch.from_numpy(valid), torch.tensor(k_max), k_max))


@pytest.mark.parametrize("seed", [0, 1])
def test_centroid_centers_and_cluster_stats(seed):
    rng = np.random.default_rng(seed)
    n, d, k_max = 500, 24, 40        # some groups stay empty
    x = rng.standard_normal((n, d)).astype(np.float32)
    jseeds, tseeds = _seeds(rng, 300, k_max, n)
    jc, jv = ja.centroid_centers(jnp.asarray(x), jseeds)
    tc, tv = ta.centroid_centers(torch.from_numpy(x), tseeds)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # members are summed in the same (seed) order; the tolerance covers a
    # different float32 association of that sum: 1e-6 · |mean|, 1e-6 abs
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    labels = rng.integers(0, k_max, n).astype(np.int32)
    dists = rng.random(n).astype(np.float32)
    np.testing.assert_array_equal(
        ta.cluster_radius(torch.from_numpy(dists), torch.from_numpy(labels),
                          k_max).numpy(),
        np.asarray(ja.cluster_radius(jnp.asarray(dists), jnp.asarray(labels),
                                     k_max)))   # a max: exact
    np.testing.assert_array_equal(
        ta.cluster_sizes(torch.from_numpy(labels), k_max).numpy(),
        np.asarray(ja.cluster_sizes(jnp.asarray(labels), k_max)))


def test_l2_kernel_wrapper_refuses_cpu_tensors():
    x, c, valid = map(torch.from_numpy, _l2_inputs(8, 3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tda.distance_argmin_l2(x, c, valid)



@pytest.mark.parametrize("n,k,d", SHAPES + [(5000, 40, 32)])
def test_l2_with_partials_matches_reference(n, k, d):
    """``assign_l2_with_partials`` (the plain version of kernel row 2)
    against ``repro``'s: labels equal but for counted near-ties, counts
    exact, sums within float32 summation error of the float64 sums
    ((members − 1) · 2⁻²⁴ · Σ|x|, recursive summation, Higham)."""
    x, c, valid = _l2_inputs(n, k, d, seed=3)
    jl, jd, js_, jc = ja.assign_l2_with_partials(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(valid), block=64)
    tl, td, ts_, tc = tops.distance_argmin_l2(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(valid),
        accumulate=True, block=64)
    assert tl.dtype == torch.int32 and ts_.dtype == tc.dtype == torch.float32
    assert_labels_match(x, c, valid, np.asarray(jl), tl.numpy(),
                        f"partials {n}x{k}x{d}")
    lab = tl.numpy().astype(np.int64)
    np.testing.assert_array_equal(tc.numpy(), np.bincount(lab, minlength=k))
    x64 = x.astype(np.float64)
    want = np.zeros((k, d))
    np.add.at(want, lab, x64)
    bound = np.zeros((k, d))
    np.add.at(bound, lab, np.abs(x64))
    bound *= np.maximum(tc.numpy()[:, None] - 1, 0) * 2.0**-24
    assert np.all(np.abs(ts_.numpy() - want) <= bound + 1e-30)
    if np.array_equal(np.asarray(jl), tl.numpy()):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), rtol=0,
                                   atol=float(bound.max() * 2 + 1e-30))
