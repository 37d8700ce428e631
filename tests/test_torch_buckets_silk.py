"""The port's bucket tables and SILK seeding against ``repro``, bit for bit.

Given the reference's hash matrix ``h`` the even partition is identical;
given identical tables and SILK keys, every integer output of SILK
(``Seeds``, ``k_star``, ``overflow``) is identical, including the cases
where k* is 0 and where the pair cap overflows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import carrier
from repro.core import buckets as jb
from repro.core import silk as js
from repro_torch.core import buckets as tb
from repro_torch.core import silk as ts


def _tables(n, m, t, seed, ties=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, m)).astype(np.float32)
    if ties:                       # repeated values: the sort must be stable
        h = np.round(h * 2) / 2
    return h, jb.partition_even(jnp.asarray(h), t), tb.partition_even(
        torch.from_numpy(h), t)


@pytest.mark.parametrize("n,m,t,ties", [(2000, 16, 32, False),
                                        (1000, 8, 64, True),
                                        (257, 4, 7, True)])
def test_partition_even_bit_identical(n, m, t, ties):
    _, jt, tt = _tables(n, m, t, n, ties)
    np.testing.assert_array_equal(tt.ids.numpy(), np.asarray(jt.ids))
    np.testing.assert_array_equal(tt.segments.numpy(), np.asarray(jt.segments))
    np.testing.assert_array_equal(tt.num_buckets.numpy(),
                                  np.asarray(jt.num_buckets))
    jf, tf = jt.flatten(), tt.flatten()
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tt.total_bucket_cap == jt.total_bucket_cap


@pytest.mark.parametrize("seed", [0, 1])
def test_lexsort_matches_jnp(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, 300).astype(np.int32)
    b = rng.integers(-3, 3, 300).astype(np.int32)
    c = rng.random(300) < 0.3
    want = np.asarray(jnp.lexsort((jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c))))
    got = ts.lexsort((torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_top_groups_tie_order():
    """``lax.top_k`` sends ties to the lower index: sizes [1,3,3,0,3]
    keep groups 1, 2, 4 in that order."""
    sizes = [1, 3, 3, 0, 3]
    group = np.repeat(np.arange(5), sizes).astype(np.int32)
    C = group.size
    ids = np.arange(C, dtype=np.int32)
    valid = np.ones(C, bool)
    jp = js.SeedPairs(jnp.asarray(group), jnp.asarray(ids), jnp.asarray(valid),
                      jnp.int32(5), jnp.int32(0))
    tp = ts.SeedPairs(torch.from_numpy(group), torch.from_numpy(ids),
                      torch.from_numpy(valid), torch.tensor(5), torch.tensor(0))
    want = js.select_top_groups(jp, 5, 3)
    got = ts.select_top_groups(tp, 5, 3)
    np.testing.assert_array_equal(got.group.numpy(), np.asarray(want.group))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.k_star) == int(want.k_star) == 3
    assert got.group[group == 1].unique().tolist() == [0]


def _assert_seeds_equal(got, want):
    for f in ("group", "id", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert int(got.k_star) == int(want.k_star)
    assert got.k_max == want.k_max


@pytest.mark.parametrize("n,m,t,delta,pair_cap,k_max", [
    (2000, 16, 32, 10, 1 << 14, 64),   # ragged buckets (32 ∤ 2000)
    (2000, 16, 32, 10, 512, 64),       # the pair cap overflows
    (1000, 8, 16, 10**6, 1 << 12, 32), # no core reaches delta: k* = 0
])
def test_silk_seeding_bit_identical(n, m, t, delta, pair_cap, k_max):
    rng = np.random.default_rng(n + delta)
    # clustered rows so that SILK finds real cores
    centers = rng.standard_normal((8, 12)).astype(np.float32)
    x = (centers[rng.integers(0, 8, n)]
         + 0.05 * rng.standard_normal((n, 12))).astype(np.float32)
    a = rng.standard_normal((12, m)).astype(np.float32)
    h = (x.astype(np.float64) @ a).astype(np.float32)  # one h for both
    silk_k, silk_l = 3, 5
    keys = rng.integers(0, 2**32, (silk_l + 1, silk_k, 2),
                        dtype=np.uint64).astype(np.uint32)
    keys[..., 0] |= 1
    jt = jb.partition_even(jnp.asarray(h), t)
    tt = tb.partition_even(torch.from_numpy(h), t)
    kw = dict(silk_k=silk_k, silk_l=silk_l, delta=delta, pair_cap=pair_cap,
              k_max=k_max)
    # the reference derives its table keys from a JAX key; feed the same
    # keys to its rounds by replicating its body's key use
    want, want_over = _jax_silk_with_keys(jt, jnp.asarray(keys), **kw)
    got, got_over = ts.silk_seeding(tt, carrier(keys), **kw)
    _assert_seeds_equal(got, want)
    assert int(got_over) == int(want_over)
    if delta == 10**6:
        assert int(got.k_star) == 0
    else:
        assert int(got.k_star) > 0
    if pair_cap == 512:
        assert int(got_over) > 0


def _jax_silk_with_keys(buckets, table_keys, *, silk_k, silk_l, delta,
                        pair_cap, k_max):
    """``repro.core.silk.silk_seeding`` with its derived table keys
    replaced by given ones (its body otherwise verbatim)."""
    import jax
    flat_ids, flat_seg = buckets.flatten()
    entry_valid = jnp.ones_like(flat_ids, dtype=bool)
    nbcap = buckets.total_bucket_cap
    rounds = jax.vmap(
        lambda tk: js.silk_round(flat_ids, flat_seg, entry_valid, nbcap, tk,
                                 delta, 2, pair_cap))(table_keys[:silk_l])
    offs = (jnp.arange(silk_l, dtype=jnp.int32) * pair_cap)[:, None]
    cat_group = jnp.where(rounds.valid, rounds.group + offs, -1).reshape(-1)
    cat_ids = rounds.id.reshape(-1)
    cat_valid = rounds.valid.reshape(-1)
    group_cap = silk_l * pair_cap
    seg = jnp.where(cat_valid, cat_group, group_cap - 1)
    dedup = js.silk_round(cat_ids, seg, cat_valid, group_cap,
                          table_keys[silk_l], 1, 1, pair_cap)
    seeds = js.select_top_groups(dedup, pair_cap, k_max)
    return seeds, rounds.overflow.sum() + dedup.overflow


def test_silk_seeding_matches_reference_key_derivation():
    """The reference's own ``silk_seeding`` (keys derived from a JAX key)
    equals the port fed those derived keys."""
    import jax
    from repro.utils.hashing import derive_hash_keys
    h, jt, tt = _tables(600, 8, 16, 3)
    key = jax.random.PRNGKey(7)
    kw = dict(silk_k=3, silk_l=5, delta=3, pair_cap=1 << 12, k_max=32)
    want, want_over = js.silk_seeding(jt, key, **kw)
    keys = np.asarray(derive_hash_keys(key, (6, 3)))
    got, got_over = ts.silk_seeding(tt, carrier(keys), **kw)
    _assert_seeds_equal(got, want)
    assert int(got_over) == int(want_over)


@pytest.mark.parametrize("seed", [0, 1])
def test_silk_round_pieces_bit_identical(seed):
    """compact_pairs and bins_from_signatures on random inputs, with
    invalid entries and colliding signatures."""
    rng = np.random.default_rng(seed)
    sig = rng.integers(0, 6, 50).astype(np.uint32)
    bval = rng.random(50) < 0.7
    jbin, jnb = js.bins_from_signatures(jnp.asarray(sig), jnp.asarray(bval))
    tbin, tnb = ts.bins_from_signatures(carrier(sig), torch.from_numpy(bval))
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
    np.testing.assert_array_equal(tbin.numpy()[bval], np.asarray(jbin)[bval])
    g = rng.integers(-1, 9, 80).astype(np.int32)
    i = rng.integers(0, 100, 80).astype(np.int32)
    v = g >= 0
    want = js.compact_pairs(jnp.asarray(g), jnp.asarray(i), jnp.asarray(v), 30)
    got = ts.compact_pairs(torch.from_numpy(g), torch.from_numpy(i),
                           torch.from_numpy(v), 30)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n,mt,t,ties", [(700, 4, 16, False),
                                         (513, 3, 32, True)])
def test_rank_partition_slice_bit_identical(n, mt, t, ties):
    """The owned-table slice of the sharded fit: ids, segments, the
    bucket of each object and the bucket sizes, as the reference's."""
    rng = np.random.default_rng(n)
    h = rng.standard_normal((n, mt)).astype(np.float32)
    if ties:
        h = np.round(h * 2) / 2
    want = jb.rank_partition_slice(jnp.asarray(h), t)
    got = tb.rank_partition_slice(torch.from_numpy(h), t)
    for w, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


def test_signature_partition_slice_bit_identical():
    rng = np.random.default_rng(5)
    sigs = rng.integers(0, 40, (3, 600)).astype(np.uint32)   # collisions
    sigs[1] = rng.integers(0, 2**32, 600, dtype=np.uint64).astype(np.uint32)
    want = jb.signature_partition_slice(jnp.asarray(sigs))
    got = tb.signature_partition_slice(carrier(sigs))
    for w, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


@pytest.mark.parametrize("min_bin_size", [1, 2])
def test_rowwise_majority_bit_identical(min_bin_size):
    """Per-object majority voting (the sharded SILK round) as the
    reference's, sentinel padding slots included."""
    rng = np.random.default_rng(min_bin_size)
    nbcap = 60
    bins_rows = rng.integers(0, 12, (300, 9)).astype(np.int32)
    bins_rows[rng.random((300, 9)) < 0.1] = nbcap          # padding slots
    bin_nbuckets = rng.integers(0, 7, nbcap).astype(np.int32)
    ws, wm = js.rowwise_majority(jnp.asarray(bins_rows),
                                 jnp.asarray(bin_nbuckets), min_bin_size)
    gs, gm = ts.rowwise_majority(torch.from_numpy(bins_rows),
                                 torch.from_numpy(bin_nbuckets), min_bin_size)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gm.any()
