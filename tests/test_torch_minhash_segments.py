"""Bucket MinHash over CSR segments: the port against ``repro``, on the
layouts the kernel's two routes and their thresholds meet.

The same seeded numpy inputs go through the reference's
``repro.core.lsh.minhash_over_segments`` and through the port's
``ops.minhash_segments`` (its plain version on the CPU), bit for bit, on
every layout of ``minhash_buckets.MINHASH_CASES`` (the card's tests hold
the kernel to the plain version on the same layouts). The wrapper's host
side (which route a layout takes, how large the device work list must
be) is held here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import carrier, u32
from repro.core import lsh as jlsh
from repro.kernels import minhash_buckets as jmh
from repro_torch.kernels import minhash_buckets as tmh
from repro_torch.kernels import ops as tops


def _keys(rng, K):
    k = rng.integers(0, 2**32, (K, 2), dtype=np.uint64).astype(np.uint32)
    k[:, 0] |= 1
    return k


def _reference(ids, offsets, keys):
    """The reference's segment MinHash of the ids that ``offsets`` cover."""
    S = offsets.size - 1
    seg = np.repeat(np.arange(S), np.diff(offsets)).astype(np.int32)
    return np.asarray(jlsh.minhash_over_segments(
        jnp.asarray(ids[offsets[0]:offsets[-1]]), jnp.asarray(seg), S,
        jnp.asarray(keys)))


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("case", tmh.MINHASH_CASES)
def test_minhash_segments_bit_identical_to_reference(case, K):
    rng = np.random.default_rng([K, len(case)])
    ids, offsets = tmh.minhash_case(case, rng)
    keys = _keys(rng, K)
    got = tops.minhash_segments(torch.from_numpy(ids),
                                torch.from_numpy(offsets), carrier(keys))
    assert got.dtype == torch.int64 and got.shape == (offsets.size - 1,)
    np.testing.assert_array_equal(u32(got), _reference(ids, offsets, keys))


def test_even_rows_equal_the_tpu_kernel():
    """The LM-shaped even rows through the reference's Pallas kernel
    (interpret mode), the reference's segment MinHash and the port."""
    rng = np.random.default_rng(7)
    ids, offsets = tmh.minhash_case("even rows", rng)
    keys = _keys(rng, 3)
    bsz = int(offsets[1] - offsets[0])
    pallas = np.asarray(jmh.minhash_even_buckets(
        jnp.asarray(ids.reshape(-1, bsz)), jnp.asarray(keys), bb=8,
        interpret=True))
    np.testing.assert_array_equal(pallas, _reference(ids, offsets, keys))
    np.testing.assert_array_equal(
        u32(tops.minhash_even_buckets(torch.from_numpy(ids.reshape(-1, bsz)),
                                      carrier(keys))), pallas)


#: which route each case takes at the committed thresholds
ROUTES = {"signature partition": True, "every segment empty": True,
          "offsets[0] > 0": True, "one long segment among singletons": True,
          "sizes at the thresholds": True,
          "sizes at the thresholds, no empty segment": False,
          "even rows": False}


@pytest.mark.parametrize("case", tmh.MINHASH_CASES)
def test_cases_take_their_route_and_meet_the_thresholds(case):
    ids, offsets = tmh.minhash_case(case, np.random.default_rng(0))
    sizes = np.diff(offsets)
    assert tmh.lane_layout(ids.size, sizes.size) == ROUTES[case]
    if case.startswith("sizes at the thresholds"):
        for size in (tmh.SHORT_MAX - 1, tmh.SHORT_MAX, tmh.SHORT_MAX + 1,
                     tmh.CHUNK, tmh.CHUNK + 1, 2 * tmh.CHUNK + 1):
            assert (sizes == size).any(), size
    if case == "signature partition":
        # empty tails, singletons, and a bucket of more than one job
        assert (sizes == 0).mean() > 0.5 and (sizes == 1).any()
        assert sizes.max() > tmh.CHUNK


def test_lane_layout_follows_the_mean_segment():
    T = tmh.SHORT_MAX
    # the code-space fits: L·n segments over L·n ids
    assert tmh.lane_layout(40_000_000, 40_000_000)
    # the dense fits' even partition and the LM cell's per-head fits
    assert not tmh.lane_layout(2560 * 15625, 2560)
    assert not tmh.lane_layout(512 * 64, 512)
    assert tmh.lane_layout(T * 100, 100)
    assert not tmh.lane_layout(T * 100 + 1, 100)
    assert tmh.lane_layout(0, 1)
    assert not tmh.lane_layout(8 * 100, 100, short_max=7)


def _needed(sizes, short_max, chunk):
    """(jobs, slots) the device list takes for these segment sizes."""
    long = sizes[sizes > short_max]
    jobs = (long - 1) // chunk + 1
    return int(jobs.sum()), int((jobs > 1).sum())


@pytest.mark.parametrize("short_max,chunk", [(16, 1024), (8, 512), (32, 4096),
                                             (0, 1), (3, 3)])
def test_work_sizes_bound_every_layout(short_max, chunk):
    """``work_sizes`` is the most any layout of P ids can need: checked on
    every case, and on the layouts that need most jobs (every segment just
    past ``short_max``, or of one id more than ``chunk``) and most slots."""
    layouts = [np.diff(tmh.minhash_case(c, np.random.default_rng(1))[1])
               for c in tmh.MINHASH_CASES]
    for P in (1, 97, 5000):
        for size in (short_max + 1, chunk + 1, chunk, 2 * chunk + 1, P):
            if size >= 1:
                layouts.append(np.full(P // size, size))
    for sizes in layouts:
        P = int(sizes.sum())
        jobs, slots, ints = tmh.work_sizes(P, short_max, chunk)
        need_jobs, need_slots = _needed(sizes, short_max, chunk)
        assert need_jobs <= jobs and need_slots <= slots, (sizes[:5], P)
        assert ints == 4 + 4 * jobs + tmh.SLOT_INTS * slots


def test_work_sizes_refuse_bad_thresholds():
    with pytest.raises(ValueError):
        tmh.work_sizes(100, chunk=0)
    with pytest.raises(ValueError):
        tmh.work_sizes(100, short_max=-1)


def test_minhash_case_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown"):
        tmh.minhash_case("no such layout", np.random.default_rng(0))
