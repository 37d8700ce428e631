"""The port's hashing primitives and bucket MinHash against ``repro``.

Integer stages are held bit for bit: the same numpy inputs go through
``repro`` (jnp, and the Pallas MinHash kernel in interpret mode) and
through ``repro_torch`` (plain path on the CPU; the CUDA kernel on the
card, where one is present).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import carrier, u32
from repro.core import lsh as jlsh
from repro.kernels import minhash_buckets as jmh
from repro.kernels import ref as jref
from repro.utils import hashing as jh
from repro_torch.core import lsh as tlsh
from repro_torch.kernels import minhash_buckets as tmh
from repro_torch.kernels import ops as tops
from repro_torch.utils import hashing as th


def _keys(rng, K):
    k = rng.integers(0, 2**32, (K, 2), dtype=np.uint64).astype(np.uint32)
    k[:, 0] |= 1
    return k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_primitives_bit_identical(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    y = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    acc = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    (a, b), = _keys(rng, 1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    ja, jb = jnp.uint32(a), jnp.uint32(b)
    np.testing.assert_array_equal(
        u32(th.hash_u32(tx, int(a), int(b))), np.asarray(jh.hash_u32(x, ja, jb)))
    np.testing.assert_array_equal(
        u32(th.mix_u32(carrier(acc), tx)), np.asarray(jh.mix_u32(acc, x)))
    np.testing.assert_array_equal(
        u32(th.combine2_u32(tx, ty, int(a), int(b))),
        np.asarray(jh.combine2_u32(x, y, ja, jb)))


@pytest.mark.parametrize("nvalid", [0, 5, 40])
def test_run_starts_matches_reference(nvalid):
    rng = np.random.default_rng(nvalid)
    k0 = np.sort(rng.integers(0, 6, 40)).astype(np.int32)
    k1 = rng.integers(0, 3, 40).astype(np.int32)
    valid = np.arange(40) < nvalid
    got = th.run_starts(torch.from_numpy(k0), torch.from_numpy(k1),
                        valid=torch.from_numpy(valid))
    want = jh.run_starts(jnp.asarray(k0), jnp.asarray(k1),
                         valid=jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(th.run_starts(torch.from_numpy(k0)).numpy(),
                                  np.asarray(jh.run_starts(jnp.asarray(k0))))


def test_derive_hash_keys_shape_range_and_odd_a():
    gen = torch.Generator().manual_seed(0)
    k = th.derive_hash_keys(gen, (6, 3))
    assert k.shape == (6, 3, 2) and k.dtype == torch.int64
    assert int(k.min()) >= 0 and int(k.max()) < 2**32
    assert bool((k[..., 0] & 1).eq(1).all())


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("typed", [False, True])
def test_derive_hash_keys_from_key_matches_reference(seed, typed):
    """The Threefry-2x32 derivation reproduces ``repro``'s
    ``derive_hash_keys`` bit for bit, for raw and typed keys, split as the
    sparse fit splits its key, at several shapes."""
    import jax
    key = jax.random.key(seed) if typed else jax.random.PRNGKey(seed)
    for k in [key, *jax.random.split(key, 4)]:
        raw = np.asarray(jax.random.key_data(k) if typed else k)
        for shape in [(1,), (3,), (6, 3), (5, 3, 2)]:
            np.testing.assert_array_equal(
                u32(th.derive_hash_keys_from_key(carrier(raw), shape)),
                np.asarray(jh.derive_hash_keys(k, shape)))


@pytest.mark.parametrize("seed", [0, 7, 0x6EEC, 2**40 + 3])
@pytest.mark.parametrize("num", [1, 2, 3, 5])
def test_split_matches_reference(seed, num):
    """``split`` reproduces ``jax.random.split`` bit for bit, the keys the
    center index derives its Hamming hashes from."""
    import jax
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        u32(th.split(carrier(np.asarray(key)), num)),
        np.asarray(jax.random.split(key, num)))


def test_qalsh_hash_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    a = rng.standard_normal((24, 8)).astype(np.float32)
    got = tlsh.qalsh_hash(torch.from_numpy(x), torch.from_numpy(a)).numpy()
    # float32 products summed in another order: a few ulps of |x|·|a|
    np.testing.assert_allclose(got, np.asarray(jlsh.qalsh_hash(x, a)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P,S,K", [(500, 40, 1), (2000, 64, 3), (777, 300, 5)])
def test_minhash_over_segments_bit_identical(P, S, K):
    """Random segments (some empty) and a validity mask."""
    rng = np.random.default_rng(P)
    ids = rng.integers(0, 10**6, P).astype(np.int32)
    seg = rng.integers(0, S, P).astype(np.int32)
    valid = rng.random(P) < 0.8
    keys = _keys(rng, K)
    want = jlsh.minhash_over_segments(jnp.asarray(ids), jnp.asarray(seg), S,
                                      jnp.asarray(keys),
                                      valid=jnp.asarray(valid))
    got = tlsh.minhash_over_segments(torch.from_numpy(ids),
                                     torch.from_numpy(seg), S, carrier(keys),
                                     valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("nb,bsz,K", [(10, 8, 1), (100, 64, 3), (33, 17, 5)])
def test_minhash_even_buckets_plain_path_bit_identical(nb, bsz, K):
    """The port's plain path vs the Pallas kernel (interpret) and ref."""
    rng = np.random.default_rng(nb)
    ids = rng.integers(0, 2**31 - 1, (nb, bsz)).astype(np.int32)
    keys = _keys(rng, K)
    pallas = np.asarray(jmh.minhash_even_buckets(
        jnp.asarray(ids), jnp.asarray(keys), bb=8, interpret=True))
    ref = np.asarray(jref.minhash_even_buckets_ref(jnp.asarray(ids),
                                                   jnp.asarray(keys)))
    got = u32(tops.minhash_even_buckets(torch.from_numpy(ids), carrier(keys)))
    np.testing.assert_array_equal(pallas, ref)
    np.testing.assert_array_equal(got, ref)


def _ragged(rng, S, empty_every=4):
    sizes = rng.integers(1, 40, S)
    sizes[::empty_every] = 0                   # empty segments
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    ids = rng.integers(0, 10**6, int(offsets[-1])).astype(np.int32)
    return ids, offsets


@pytest.mark.parametrize("S,K", [(1, 3), (50, 3), (257, 2)])
def test_minhash_csr_equals_over_segments(S, K):
    """CSR segments (ragged, some empty) = the segment-id formulation,
    which is the reference's ``minhash_over_segments``."""
    rng = np.random.default_rng(S)
    ids, offsets = _ragged(rng, S)
    keys = _keys(rng, K)
    seg = np.repeat(np.arange(S), np.diff(offsets)).astype(np.int32)
    want = np.asarray(jlsh.minhash_over_segments(
        jnp.asarray(ids), jnp.asarray(seg), S, jnp.asarray(keys)))
    got = tops.minhash_segments(torch.from_numpy(ids),
                                torch.from_numpy(offsets), carrier(keys))
    np.testing.assert_array_equal(u32(got), want)
    # an empty segment mixes UINT32_MAX (segment_min's identity) K times
    empty = np.flatnonzero(np.diff(offsets) == 0)
    sig = np.zeros(1, np.uint32)
    for _ in range(K):
        sig = np.asarray(jh.mix_u32(sig, np.full(1, 0xFFFFFFFF, np.uint32)))
    np.testing.assert_array_equal(want[empty], np.repeat(sig, empty.size))


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback inside a kernel wrapper: only ops dispatches to the
    plain version, and only for CPU tensors."""
    ids = torch.zeros((4, 8), dtype=torch.int32)
    keys = carrier(_keys(np.random.default_rng(0), 2))
    with pytest.raises(ValueError, match="CUDA"):
        tmh.minhash_even_buckets(ids, keys)
    with pytest.raises(ValueError, match="CUDA"):
        tmh.minhash_segments(ids.reshape(-1), torch.tensor([0, 32],
                                                           dtype=torch.int32),
                             keys)

