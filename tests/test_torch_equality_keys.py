"""The equality Hamming kernel's arithmetic on the CPU: the tile keys.

``repro_torch.kernels.ref.distance_argmin_hamming_keys`` is the argmin of
``csrc/distance_argmin_hamming.cu`` (``equality_argmin_kernel``, d <= 32)
written as plain torch: a center's key count·32 + its index in its tile
of 32, formed from a per-center offset less 32 for every equal column, the
least key of each tile, and the tiles merged with a strict '<' in
ascending order. It is held, with the port's plain version
``ref.distance_argmin_hamming_ref``, to the reference's
``repro.core.assign.assign_hamming`` over the kernel's edge cases
(``ref.EQUALITY_CASES`` at every width of ``ref.EQUALITY_WIDTHS``, which
the card tests and ``chip_smoke.py`` hold the kernel to) and over
hypothesis-drawn int32 codes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st

from repro.core import assign as jassign
from repro_torch.kernels import ref as tref

INT32 = st.integers(-2**31, 2**31 - 1)


def _reference(codes, cen, valid):
    jl, jc = jassign.assign_hamming(jnp.asarray(codes.numpy()),
                                    jnp.asarray(cen.numpy()),
                                    jnp.asarray(valid.numpy()))
    return np.asarray(jl), np.asarray(jc).astype(np.int64)


def _assert_all_agree(codes, cen, valid):
    """The port's plain version and, where the kernel forms keys (d <= 32),
    the key mirror equal the reference's labels and counts."""
    jl, jc = _reference(codes, cen, valid)
    lab, cnt = tref.distance_argmin_hamming_ref(codes, cen, valid)
    np.testing.assert_array_equal(lab.numpy(), jl)
    np.testing.assert_array_equal(cnt.numpy(), jc)
    if codes.shape[1] <= 32:
        kl, kc = tref.distance_argmin_hamming_keys(codes, cen, valid)
        np.testing.assert_array_equal(kl.numpy(), jl)
        np.testing.assert_array_equal(kc.numpy(), jc)
    return lab, cnt


@pytest.mark.parametrize("d", tref.EQUALITY_WIDTHS)
@pytest.mark.parametrize("case", tref.EQUALITY_CASES)
def test_equality_case_matches_reference(case, d):
    """Each edge case at each width: the three agree, and the case shows
    what it is built for."""
    codes, cen, valid = tref.equality_case(
        case, d, 90, torch.Generator().manual_seed(d))
    lab, cnt = _assert_all_agree(codes, cen, valid)
    if case == "no valid center":
        assert bool((lab == 0).all()) and bool((cnt == d + 1).all())
        return
    assert bool(valid[lab].all())
    assert torch.equal(cnt, (codes != cen[lab]).sum(dim=1, dtype=torch.int32))
    if case == "every center identical":          # the first valid wins
        assert bool((lab == int(valid.nonzero()[0])).all())
    elif case == "dead tile between live ones":   # rows equal to center 40
        assert not bool(((lab >= 20) & (lab < 64)).any())
    elif case == "pad sentinels":
        assert bool(((codes == -1) | (codes == -2)).any())
        assert bool((cnt[::3] == 0).any())
    elif case == "int32 extremes":
        assert bool((codes == tref.INT32_MIN).any())
        assert bool((codes == tref.INT32_MAX).any())


@pytest.mark.parametrize("d", [1, 9, 32])
@given(values=st.lists(st.one_of(st.integers(-3, 3), INT32), min_size=1,
                       max_size=8),
       seed=st.integers(0, 2**32 - 1))
def test_equality_keys_random_codes(d, values, seed):
    """Codes and centers drawn from a few int32 values (any, int32's
    extremes among them), so that counts tie and reach 0, a third of the
    rows copied from centers, any validity over two tiles, the second
    partial."""
    n, k = 24, 40
    rng = np.random.default_rng(seed)
    pool = np.asarray(values, dtype=np.int64).astype(np.int32)
    codes = torch.from_numpy(pool[rng.integers(0, len(pool), (n, d))])
    cen = torch.from_numpy(pool[rng.integers(0, len(pool), (k, d))])
    codes[::3] = cen[torch.from_numpy(rng.integers(0, k, len(codes[::3])))]
    valid = torch.from_numpy(rng.random(k) < rng.random())
    _assert_all_agree(codes, cen, valid)


def test_equality_keys_main_path_shape():
    """The heterogeneous main path's shape, cut in rows: 9 codes of
    cardinality 12 against 1,024 centers, all valid and a live prefix."""
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(rng.integers(0, 12, (3000, 9)).astype(np.int32))
    cen = torch.from_numpy(rng.integers(0, 12, (1024, 9)).astype(np.int32))
    codes[::3] = cen[torch.from_numpy(rng.integers(0, 1024, 1000))]
    for valid in (torch.ones(1024, dtype=torch.bool),
                  torch.arange(1024) < 158):
        _assert_all_agree(codes, cen, valid)
