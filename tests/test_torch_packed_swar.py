"""The packed Hamming kernel's arithmetic on the CPU: the SWAR field test.

``repro_torch.kernels.pack.field_mismatch_swar`` is the per-word count of
``csrc/distance_argmin_hamming.cu`` (``Packed::term``) written as plain
torch on the int64 carrier. It is held, for every supported field width,
to the reference's OR-fold (``repro.kernels.pack.field_mismatch_count``)
and to the port's own, word for word: over every 16-bit value in either
half of a word, over the fields' edges (a field's top bit only, its
lowest bit only, all its bits), over random words, and summed over rows
of up to 64 words in which every field mismatches. The kernel's edge
cases (``pack.PACKED_CASES``, which the card tests and ``chip_smoke.py``
hold the kernel to) are held here through the plain packed argmin
against the reference's ``assign_hamming_packed``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st

from _torch_parity import carrier
from repro.core import assign as jassign
from repro.kernels import pack as jpack
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import ref as tref

BITS = tpack.SUPPORTED_BITS


def _three_counts(z: np.ndarray, bits: int):
    """(kernel's SWAR count, port's OR-fold, reference's OR-fold) of uint32
    words ``z``, as numpy int arrays."""
    swar = tpack.field_mismatch_swar(carrier(z), bits).numpy()
    fold = tpack.field_mismatch_count(carrier(z), bits).numpy()
    ref = np.asarray(jpack.field_mismatch_count(jnp.asarray(z), bits))
    return swar, fold, ref


def _assert_same(z: np.ndarray, bits: int):
    swar, fold, ref = _three_counts(z, bits)
    np.testing.assert_array_equal(fold, ref)
    np.testing.assert_array_equal(swar, ref)


@pytest.mark.parametrize("half", ["low", "high"])
@pytest.mark.parametrize("bits", BITS)
def test_swar_count_every_half_word_value(bits, half):
    v = np.arange(1 << 16, dtype=np.uint32)
    _assert_same(v << np.uint32(16) if half == "high" else v, bits)


@pytest.mark.parametrize("pattern", ["top bit only", "lowest bit only",
                                     "all ones"])
@pytest.mark.parametrize("bits", BITS)
def test_swar_count_field_edges(bits, pattern):
    """The pattern in each field alone, in every field, and in random
    subsets of the fields, the other fields zero."""
    fields = 32 // bits
    value = {"top bit only": 1 << (bits - 1), "lowest bit only": 1,
             "all ones": (1 << bits) - 1}[pattern]
    shifts = np.arange(fields, dtype=np.uint64) * bits
    one = (np.uint64(value) << shifts).astype(np.uint32)      # (fields,)
    rng = np.random.default_rng(bits)
    subsets = rng.random((256, fields)) < 0.5
    subsets[0], subsets[1] = False, True                       # none, all
    words = np.bitwise_or.reduce(np.where(subsets, one, np.uint32(0)),
                                 axis=1).astype(np.uint32)
    z = np.concatenate([one, words])
    _assert_same(z, bits)
    swar, _, _ = _three_counts(z, bits)
    np.testing.assert_array_equal(swar[:fields], 1)
    np.testing.assert_array_equal(swar[fields:], subsets.sum(axis=1))


@pytest.mark.parametrize("bits", BITS)
@given(words=st.lists(st.integers(0, 2**32 - 1), min_size=64, max_size=64))
def test_swar_count_random_words(bits, words):
    _assert_same(np.asarray(words, dtype=np.uint64).astype(np.uint32), bits)


@pytest.mark.parametrize("bits", BITS)
def test_swar_row_sums_every_field_mismatching(bits):
    """Rows of 1 to 64 words whose every field mismatches, summed as the
    kernel sums a row: each row counts all its fields, as the reference's
    ``packed_hamming`` does."""
    rng = np.random.default_rng(64 + bits)
    hi = 2**32 if bits == 32 else 1 << bits
    d = 64 * (32 // bits)
    x = rng.integers(hi // 2, hi, (64, d), dtype=np.uint64)    # top bit set
    c = rng.integers(0, hi // 2, (1, d), dtype=np.uint64)      # top bit clear
    xp = tpack.pack_codes(carrier(x.astype(np.uint32)), bits)
    cp = tpack.pack_codes(carrier(c.astype(np.uint32)), bits)
    z = (xp ^ cp).to(torch.int64) & 0xFFFFFFFF                 # (64, 64)
    width = torch.arange(1, 65)[:, None]                       # row r: r + 1
    swar = torch.where(torch.arange(64)[None, :] < width,
                       tpack.field_mismatch_swar(z, bits), 0).sum(dim=1)
    np.testing.assert_array_equal(swar.numpy(),
                                  (width[:, 0] * (32 // bits)).numpy())
    jx = jpack.pack_codes(jnp.asarray(x.astype(np.uint32)), bits)
    jc = jpack.pack_codes(jnp.asarray(c.astype(np.uint32)), bits)
    ref = np.asarray(jpack.packed_hamming(jx, jc, bits))[:, 0]
    np.testing.assert_array_equal(
        tpack.field_mismatch_swar(z, bits).sum(dim=1).numpy(), ref)


@pytest.mark.parametrize("case", tpack.PACKED_CASES)
@pytest.mark.parametrize("bits", BITS)
def test_packed_cases_plain_argmin_matches_reference(bits, case):
    """Each edge case, packed: the port's plain packed argmin equals the
    reference's, and shows what the case is built for."""
    codes, cen, valid = tpack.packed_case(case, bits, 60,
                                          torch.Generator().manual_seed(bits))
    d = codes.shape[1]
    xp, cp = tpack.pack_codes(codes, bits), tpack.pack_codes(cen, bits)
    lab, cnt = tref.distance_argmin_hamming_packed_ref(xp, cp, valid,
                                                       bits=bits, d=d)
    jl, jc = jassign.assign_hamming_packed(
        jnp.asarray(xp.numpy().view(np.uint32)),
        jnp.asarray(cp.numpy().view(np.uint32)), jnp.asarray(valid.numpy()),
        bits=bits, d=d)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc).astype(int))
    assert bool(valid[lab].all())
    assert torch.equal(cnt, (codes != cen[lab]).sum(dim=1))
    if case == "every field mismatching":
        assert bool((cnt == d).all())
    elif case == "dead tile between live ones":   # rows equal to center 40
        assert bool((cnt[::3] > 0).all()) and bool((cnt[1::3] == 0).all())
