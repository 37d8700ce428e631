"""The port's code-space modules against ``repro``, module by module.

Bit packing, the numeric discretizer, DOPH, coded items, MinHash
signatures, the signature partition, mode centers and the three Hamming
assignments. Every stage here is integer (or a float comparison against
fitted boundaries), so each is held bit for bit: the same numpy inputs
go through ``repro`` (its jnp paths, ``use_pallas=False``: the Pallas
module does not import on the installed JAX) and through ``repro_torch``
on the CPU. Kernel tests on the card are in ``test_torch_cuda.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import carrier, u32
from repro.core import assign as ja
from repro.core import buckets as jb
from repro.core import lsh as jlsh
from repro.core import model as jmodel
from repro.core import silk as js
from repro.kernels import pack as jpack
from repro.kernels import ref as jref
from repro.utils.hashing import derive_hash_keys
from repro_torch.core import assign as ta
from repro_torch.core import buckets as tb
from repro_torch.core import lsh as tlsh
from repro_torch.core import model as tmodel
from repro_torch.core import silk as ts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import ref as tref
from repro_torch.utils.hashing import u32_as_i32

BITS = (1, 2, 4, 8, 16, 32)


def _codes(rng, shape, bits):
    hi = 2**32 if bits == 32 else 1 << bits
    c = rng.integers(0, hi, shape, dtype=np.uint64)
    return c.astype(np.uint32).astype(np.int32)     # wraps: top bit set too


def _hash_pair(rng, shape=(1,)):
    k = rng.integers(0, 2**32, shape + (2,), dtype=np.uint64).astype(np.uint32)
    k[..., 0] |= 1
    return k


# ---------------------------------------------------------------------------
# kernels/pack.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_bit_identical(bits):
    rng = np.random.default_rng(bits)
    codes = _codes(rng, (37, 13), bits)
    jp = np.asarray(jpack.pack_codes(jnp.asarray(codes), bits))
    tp = tpack.pack_codes(torch.from_numpy(codes), bits)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(u32(tp), jp)
    np.testing.assert_array_equal(
        tpack.unpack_codes(tp, bits, 13).numpy(),
        np.asarray(jpack.unpack_codes(jnp.asarray(jp), bits, 13)))
    assert tpack.packed_width(13, bits) == jpack.packed_width(13, bits)
    assert tpack.codes_per_word(bits) == jpack.codes_per_word(bits)
    # codes wider than ``bits`` are masked, as the reference does
    wide = codes.astype(np.int64) + (1 << bits if bits < 32 else 0)
    np.testing.assert_array_equal(
        u32(tpack.pack_codes(torch.from_numpy(wide), bits)), jp)


def test_bits_for_cardinality_and_popcount():
    for card in (1, 2, 3, 4, 5, 16, 17, 255, 256, 257, 65536, 65537, 2**31):
        assert tpack.bits_for_cardinality(card) == \
            jpack.bits_for_cardinality(card)
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    np.testing.assert_array_equal(
        tpack.popcount32(carrier(w)).numpy(),
        np.asarray(jpack.popcount32(jnp.asarray(w))))


@pytest.mark.parametrize("bits", BITS)
def test_field_fold_and_packed_hamming_bit_identical(bits):
    rng = np.random.default_rng(100 + bits)
    z = rng.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32)
    z[:3] = [0xFFFFFFFF, 0x80000000, 1]
    np.testing.assert_array_equal(
        tpack.field_mismatch_count(carrier(z), bits).numpy(),
        np.asarray(jpack.field_mismatch_count(jnp.asarray(z), bits)))
    x, c = _codes(rng, (29, 21), bits), _codes(rng, (11, 21), bits)
    x[:, ::3] = c[0, ::3]                        # some fields match
    jx, jc = jpack.pack_codes(jnp.asarray(x), bits), jpack.pack_codes(
        jnp.asarray(c), bits)
    tx, tc = (tpack.pack_codes(torch.from_numpy(a), bits) for a in (x, c))
    np.testing.assert_array_equal(tpack.packed_hamming(tx, tc, bits).numpy(),
                                  np.asarray(jpack.packed_hamming(jx, jc, bits)))


def test_onehot_codes_match_reference():
    rng = np.random.default_rng(1)
    codes = rng.integers(-1, 9, (17, 5)).astype(np.int32)   # -1, 8: outside
    np.testing.assert_array_equal(
        tpack.onehot_codes(torch.from_numpy(codes), 8).float().numpy(),
        np.asarray(jpack.onehot_codes(jnp.asarray(codes), 8), np.float32))


def test_u32_as_i32_keeps_bits():
    w = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0xDEADBEEF], np.uint32)
    got = u32_as_i32(carrier(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), w)


# ---------------------------------------------------------------------------
# core/model.py: the numeric discretizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,t_cat", [(500, 16), (7, 16), (64, 5)])
def test_numeric_discretizer_bit_identical(n, t_cat):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    x[: n // 3, 1] = np.round(x[: n // 3, 1])              # ties
    jd = jmodel.NumericDiscretizer.fit(jnp.asarray(x), t_cat)
    td = tmodel.NumericDiscretizer.fit(torch.from_numpy(x), t_cat)
    np.testing.assert_array_equal(td.boundaries.numpy(),
                                  np.asarray(jd.boundaries))
    assert (td.d_num, td.t_cat) == (jd.d_num, jd.t_cat)
    q = np.concatenate([x, rng.standard_normal((50, 4)).astype(np.float32),
                        np.asarray(jd.boundaries).T[:3]])  # on a boundary
    np.testing.assert_array_equal(td(torch.from_numpy(q)).numpy(),
                                  np.asarray(jd(jnp.asarray(q))))


# ---------------------------------------------------------------------------
# core/lsh.py: DOPH, coded items, MinHash signatures
# ---------------------------------------------------------------------------

def test_doph_codes_bit_identical(m=64):
    rng = np.random.default_rng(m)
    sets = rng.integers(0, 10**6, (40, 24)).astype(np.int32)
    mask = rng.random((40, 24)) < 0.7
    mask[0] = False                                    # empty set
    mask[1] = False
    mask[1, 0] = True                                  # one item: most bins borrow
    # the reference derives its pair from a key; the port takes the pair
    key = jax.random.PRNGKey(m)
    pair = np.asarray(derive_hash_keys(key, (1,)))
    want = np.asarray(jax.jit(jlsh.doph_codes, static_argnums=3)(
        jnp.asarray(sets), jnp.asarray(mask), key, m))
    got = tlsh.doph_codes(torch.from_numpy(sets), torch.from_numpy(mask),
                          carrier(pair), m)
    np.testing.assert_array_equal(u32(got), want)


def test_code_items_and_minhash_signatures_bit_identical():
    rng = np.random.default_rng(3)
    codes = rng.integers(-5, 40, (60, 9)).astype(np.int32)
    key = jax.random.PRNGKey(9)
    pair = np.asarray(derive_hash_keys(key, (1,)))
    items_j = jlsh.code_items(jnp.asarray(codes), key)
    items_t = tlsh.code_items(torch.from_numpy(codes), carrier(pair))
    np.testing.assert_array_equal(u32(items_t), np.asarray(items_j))
    keys = _hash_pair(rng, (4, 3))
    mask = rng.random((60, 9)) < 0.8
    for m in (mask, np.ones_like(mask)):
        want = jlsh.minhash_signatures(items_j, jnp.asarray(m),
                                       jnp.asarray(keys))
        got = tlsh.minhash_signatures(items_t, torch.from_numpy(m),
                                      carrier(keys))
        np.testing.assert_array_equal(u32(got), np.asarray(want))
    # mask=None is the all-True mask
    np.testing.assert_array_equal(
        u32(tlsh.minhash_signatures(items_t, None, carrier(keys))),
        u32(tlsh.minhash_signatures(items_t, torch.ones(60, 9, dtype=bool),
                                    carrier(keys))))


# ---------------------------------------------------------------------------
# core/buckets.py + SILK over signature tables
# ---------------------------------------------------------------------------

def test_partition_by_signature_bit_identical_and_csr_minhash():
    """Signature tables at nbcap = L·n are mostly empty and singleton
    segments. The partition is held against the reference; the SILK
    round's CSR path (the MinHash kernel's, plain here) is held against
    its masked segment path on those tables (the whole fits of
    ``test_torch_fit_codes.py`` hold SILK against the reference)."""
    rng = np.random.default_rng(4)
    L, n = 20, 300
    sigs = rng.integers(0, 40, (L, n)).astype(np.uint32)    # many ties
    sigs[3] = rng.integers(0, 2**32, n, dtype=np.uint64)     # all singletons
    sigs[5] = 7                                              # one bucket
    jt = jb.partition_by_signature(jnp.asarray(sigs))
    tt = tb.partition_by_signature(carrier(sigs))
    for f in ("ids", "segments", "num_buckets"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    assert tt.buckets_per_table == jt.buckets_per_table == n
    ids, seg = tt.flatten()
    nbcap = tt.total_bucket_cap
    offsets = torch.searchsorted(seg, torch.arange(nbcap + 1, dtype=torch.int32)
                                 ).to(torch.int32)
    sizes = offsets[1:] - offsets[:-1]
    assert nbcap == L * n and int((sizes == 0).sum()) > nbcap // 2
    assert int((sizes == 1).sum()) >= n
    keys = carrier(_hash_pair(rng, (3,)))
    valid = torch.ones_like(ids, dtype=torch.bool)
    np.testing.assert_array_equal(
        tops.minhash_segments(ids, offsets, keys).numpy(),
        tlsh.minhash_over_segments(ids, seg, nbcap, keys, valid=valid).numpy())
    for r_csr, r_seg in zip(
            ts.silk_round(ids, seg, valid, nbcap, keys, 3, 2, 1 << 12,
                          offsets=offsets),
            ts.silk_round(ids, seg, valid, nbcap, keys, 3, 2, 1 << 12)):
        np.testing.assert_array_equal(r_csr.numpy(), r_seg.numpy())


# ---------------------------------------------------------------------------
# core/assign.py: mode centers and the three Hamming impls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("card", [3, 1 << 16])
def test_mode_centers_bit_identical(card):
    rng = np.random.default_rng(card)
    n, d, C, k_max = 400, 7, 600, 16
    codes = rng.integers(0, card, (n, d)).astype(np.int32)
    codes[:, 0] = rng.integers(0, 2, n)                 # ties in counts
    group = rng.integers(-1, k_max - 3, C).astype(np.int32)
    valid = group >= 0
    ids = rng.integers(0, n, C).astype(np.int32)

    @jax.jit
    def jmodes(codes, group, ids, valid):
        return ja.mode_centers(codes, js.Seeds(group, ids, valid,
                                               jnp.int32(k_max - 3), k_max),
                               attr_chunk=3)

    ts_ = ts.Seeds(torch.from_numpy(group), torch.from_numpy(ids),
                   torch.from_numpy(valid), torch.tensor(k_max - 3), k_max)
    jc, jv = jmodes(*map(jnp.asarray, (codes, group, ids, valid)))
    for chunk in (3, 64):
        tc, tv = ta.mode_centers(torch.from_numpy(codes), ts_,
                                 attr_chunk=chunk)
        assert tc.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _ham_inputs(seed, n, k, d, card, valid_every=7):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, card, (n, d)).astype(np.int32)
    c = rng.integers(0, card, (k, d)).astype(np.int32)
    codes[::5] = c[rng.integers(0, k, len(codes[::5]))]   # exact hits
    valid = np.arange(k) % valid_every != 3
    return codes, c, valid


@pytest.mark.parametrize("n,k,d,card", [(50, 4, 9, 5), (129, 17, 45, 20),
                                        (64, 8, 400, 1 << 15)])
def test_hamming_equality_bit_identical(n, k, d, card):
    codes, c, valid = _ham_inputs(n, n, k, d, card)
    jl, jd = ja.assign_hamming(jnp.asarray(codes), jnp.asarray(c),
                               jnp.asarray(valid))
    for block in (32, 4096):
        tl, td = tops.distance_argmin_hamming(
            torch.from_numpy(codes), torch.from_numpy(c),
            torch.from_numpy(valid), block=block)
        assert tl.dtype == torch.int32 and td.dtype == torch.float32
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    rl, rd = tref.distance_argmin_hamming_ref(
        torch.from_numpy(codes), torch.from_numpy(c), torch.from_numpy(valid))
    np.testing.assert_array_equal(rl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(jd).astype(np.int32))
    # the reference's own oracle agrees where a center is valid
    ol, od = jref.distance_argmin_hamming_ref(jnp.asarray(codes),
                                              jnp.asarray(c),
                                              jnp.asarray(valid))
    np.testing.assert_array_equal(rl.numpy(), np.asarray(ol))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(od))


@pytest.mark.parametrize("n,k,d,bits", [(50, 4, 9, 4), (129, 17, 45, 8),
                                        (64, 8, 400, 16), (33, 70, 7, 2),
                                        (40, 6, 5, 1), (40, 9, 3, 32)])
def test_hamming_packed_bit_identical(n, k, d, bits):
    rng = np.random.default_rng(n * k + bits)
    codes, c = _codes(rng, (n, d), bits), _codes(rng, (k, d), bits)
    codes[::4] = c[0]
    valid = np.arange(k) % 7 != 3
    jx, jc = (jpack.pack_codes(jnp.asarray(a), bits) for a in (codes, c))
    tx, tc = (tpack.pack_codes(torch.from_numpy(a), bits) for a in (codes, c))
    for dd in (d, None):
        jl, jd = jax.jit(functools.partial(ja.assign_hamming_packed,
                                           bits=bits, d=dd))(
            jx, jc, jnp.asarray(valid))
        tl, td = tops.distance_argmin_hamming_packed(
            tx, tc, torch.from_numpy(valid), bits=bits, d=dd, block=16)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        rl, rd = tref.distance_argmin_hamming_packed_ref(
            tx, tc, torch.from_numpy(valid), bits=bits, d=dd)
        np.testing.assert_array_equal(rl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(rd.numpy(),
                                      np.asarray(jd).astype(np.int32))
    # packed counts equal the unpacked equality counts
    el, ed = tref.distance_argmin_hamming_ref(
        torch.from_numpy(codes), torch.from_numpy(c), torch.from_numpy(valid))
    np.testing.assert_array_equal(rl.numpy(), el.numpy())
    np.testing.assert_array_equal(rd.numpy(), ed.numpy())


@pytest.mark.parametrize("card", [4, 16, 256])
def test_hamming_onehot_bit_identical(card):
    """d = 300 > 256 matches: a bf16 product would round the counts."""
    codes, c, valid = _ham_inputs(card, 70, 12, 300, card)
    codes[:, :] = c[1]
    codes[1::2, ::7] = (codes[1::2, ::7] + 1) % card
    jl, jd = ja.assign_hamming_onehot(jnp.asarray(codes), jnp.asarray(c),
                                      jnp.asarray(valid), card=card)
    tl, td = ta.assign_hamming_onehot(torch.from_numpy(codes),
                                      torch.from_numpy(c),
                                      torch.from_numpy(valid), card=card,
                                      block=32)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    el, ed = ta.assign_hamming(torch.from_numpy(codes), torch.from_numpy(c),
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(tl.numpy(), el.numpy())
    np.testing.assert_array_equal(td.numpy(), ed.numpy())


def test_no_valid_center_gives_label_0_and_d_plus_1():
    codes, c, _ = _ham_inputs(0, 20, 5, 9, 4)
    none = torch.zeros(5, dtype=torch.bool)
    for lab, cnt in (
            tops.distance_argmin_hamming(torch.from_numpy(codes),
                                         torch.from_numpy(c), none),
            tops.distance_argmin_hamming_packed(
                tpack.pack_codes(torch.from_numpy(codes), 4),
                tpack.pack_codes(torch.from_numpy(c), 4), none, bits=4, d=9),
            ta.assign_hamming_onehot(torch.from_numpy(codes),
                                     torch.from_numpy(c), none, card=4)):
        assert int(lab.abs().max()) == 0 and bool((cnt == 10).all())
