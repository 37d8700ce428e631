"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs the card (marker ``cuda``) and skips with a reason
without one. The file imports no JAX, so it also runs on a machine with
the card and no JAX::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import repro_torch as rt
from _torch_parity import (DEAD_TILE_LAYOUTS,  # noqa: F401
                           InjectedBucketer, assert_labels_match, carrier,
                           cuda_device, dead_tile_layout, u32)
from repro_torch.core import model as tm
from repro_torch.kernels import distance_argmin as tda
from repro_torch.kernels import distance_argmin_hamming as tdh
from repro_torch.kernels import minhash_buckets as tmh
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "geek_ref_dense")
L2_SHAPES = [(64, 8, 16), (130, 33, 70), (257, 128, 128), (100, 5, 960)]


def _keys(rng, K):
    k = rng.integers(0, 2**32, (K, 2), dtype=np.uint64).astype(np.uint32)
    k[:, 0] |= 1
    return carrier(k)


@pytest.mark.parametrize("nb,bsz,K", [(10, 8, 1), (100, 64, 3), (33, 17, 5)])
def test_minhash_kernel_bit_exact(cuda_device, nb, bsz, K):
    rng = np.random.default_rng(nb)
    ids = torch.from_numpy(rng.integers(0, 2**31 - 1, (nb, bsz)).astype(np.int32))
    keys = _keys(rng, K)
    before = tmh.minhash_segments.launches
    got = tmh.minhash_even_buckets(ids.to(cuda_device), keys.to(cuda_device))
    assert tmh.minhash_segments.launches == before + 1
    np.testing.assert_array_equal(u32(got),
                                  u32(tops.minhash_even_buckets(ids, keys)))


def test_minhash_kernel_ragged_csr_bit_exact(cuda_device):
    rng = np.random.default_rng(0)
    sizes = rng.integers(0, 70, 301)
    sizes[::4] = 0                                     # empty segments
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    ids = rng.integers(0, 10**6, int(offsets[-1])).astype(np.int32)
    keys = _keys(rng, 3)
    got = tmh.minhash_segments(torch.from_numpy(ids).to(cuda_device),
                               torch.from_numpy(offsets).to(cuda_device),
                               keys.to(cuda_device))
    want = tops.minhash_segments(torch.from_numpy(ids),
                                 torch.from_numpy(offsets), keys)
    np.testing.assert_array_equal(u32(got), u32(want))


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("case", tmh.MINHASH_CASES)
def test_minhash_kernel_on_every_layout(cuda_device, case, K):
    """Both routes (a warp a segment; a lane a segment with the longer
    ones on the device work list) at their thresholds, bit for bit, one
    launch a call, the int64 carrier written by the kernel, and no host
    synchronization in the wrapper."""
    rng = np.random.default_rng([K, len(case)])
    ids, offsets = tmh.minhash_case(case, rng)
    keys = _keys(rng, K)
    args = (torch.from_numpy(ids).to(cuda_device),
            torch.from_numpy(offsets).to(cuda_device), keys.to(cuda_device))
    torch.cuda.synchronize()
    before = tmh.minhash_segments.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tmh.minhash_segments(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tmh.minhash_segments.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (offsets.size - 1,)
    want = tops.minhash_segments(torch.from_numpy(ids),
                                 torch.from_numpy(offsets), keys)
    assert torch.equal(got.cpu(), want)
    # the same call again: the work list starts empty each time
    assert torch.equal(tmh.minhash_segments(*args).cpu(), want)


@pytest.mark.parametrize("n,k,d", L2_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_kernel_matches_plain(cuda_device, n, k, d, dtype):
    rng = np.random.default_rng(n + k + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    valid = torch.arange(k) % 7 != 3
    tx, tc = x.to(cuda_device, dtype), c.to(cuda_device, dtype)
    kl, kd = tda.distance_argmin_l2(tx, tc, valid.to(cuda_device))
    pl, pd = tref.distance_argmin_l2_ref(tx, tc, valid.to(cuda_device))
    xf, cf = tx.float().cpu().numpy(), tc.float().cpu().numpy()
    assert_labels_match(xf, cf, valid.numpy(), pl.cpu().numpy(),
                        kl.cpu().numpy(), f"kernel {n}x{k}x{d} {dtype}")
    # d² within 1e-5 of the expansion's scale (see _torch_parity.near_ties)
    scale = (xf * xf).sum(1) + (cf[valid.numpy()] ** 2).sum(1).max()
    assert np.all(np.abs(kd.cpu().numpy() - pd.cpu().numpy()) <= 1e-5 * scale)


ACC_SHAPES = L2_SHAPES + [(20_000, 70, 128), (50_000, 1024, 32)]


def _sum_bound(x64, labels, k):
    """Per (cluster, column) bound on a float32 sum's error against the
    float64 sum: (members + slots) · 2⁻²⁴ · Σ|x| (recursive summation,
    Higham, over the kernel's two levels: rows into a slot, slots)."""
    lab = labels.cpu().numpy().astype(np.int64)
    abs_sum = np.zeros((k, x64.shape[1]))
    np.add.at(abs_sum, lab, np.abs(x64))
    cnt = np.bincount(lab, minlength=k)[:, None]
    return (cnt + tda.ACC_SLOTS) * 2.0**-24 * abs_sum + 1e-30


@pytest.mark.parametrize("n,k,d", ACC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_accumulate_kernel_matches_row1_and_plain(cuda_device, n, k, d,
                                                     dtype):
    """Kernel row 2: labels and d² equal row 1's bit for bit; labels equal
    the plain version's but for counted near-ties; counts exact; sums
    within the float32 summation bound of the float64 sums; and a second
    call gives the same bits."""
    rng = np.random.default_rng(n + k + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    valid = torch.arange(k) % 7 != 3
    tx, tc = x.to(cuda_device, dtype), c.to(cuda_device, dtype)
    tv = valid.to(cuda_device)
    before = tda.distance_argmin_l2_accumulate.launches
    out = tda.distance_argmin_l2_accumulate(tx, tc, tv)
    assert tda.distance_argmin_l2_accumulate.launches == before + 1
    labels, d2, sums, cnt = out
    l1, d1 = tda.distance_argmin_l2(tx, tc, tv)
    assert torch.equal(labels, l1) and torch.equal(d2, d1)
    again = tda.distance_argmin_l2_accumulate(tx, tc, tv)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    pl, _, _, _ = tops.distance_argmin_l2(tx.float().cpu(), tc.float().cpu(),
                                          valid, accumulate=True)
    xf, cf = tx.float().cpu().numpy(), tc.float().cpu().numpy()
    assert_labels_match(xf, cf, valid.numpy(), pl.numpy(),
                        labels.cpu().numpy(), f"acc kernel {n}x{k}x{d}")
    lab = labels.cpu().numpy().astype(np.int64)
    np.testing.assert_array_equal(cnt.cpu().numpy(),
                                  np.bincount(lab, minlength=k))
    x64 = xf.astype(np.float64)
    want = np.zeros((k, d))
    np.add.at(want, lab, x64)
    err = np.abs(sums.cpu().numpy() - want)
    assert np.all(err <= _sum_bound(x64, labels, k)), float(err.max())


def test_l2_accumulate_kernel_no_valid_center(cuda_device):
    """No valid center: every row takes label 0, as in row 1, and the
    sums of cluster 0 are all the rows'."""
    x = torch.randn(300, 24, device=cuda_device)
    c = torch.randn(10, 24, device=cuda_device)
    none = torch.zeros(10, dtype=torch.bool, device=cuda_device)
    labels, d2, sums, cnt = tda.distance_argmin_l2_accumulate(x, c, none)
    assert int(labels.max()) == 0 and float(cnt[0]) == 300
    assert float(cnt[1:].abs().sum()) == 0
    x64 = x.double().cpu().numpy()
    err = np.abs(sums[0].cpu().numpy() - x64.sum(0))
    assert np.all(err <= (300 + tda.ACC_SLOTS) * 2.0**-24
                  * np.abs(x64).sum(0) + 1e-30)


@pytest.mark.parametrize("n,k,d", ACC_SHAPES)
@pytest.mark.parametrize("valid_mode", ["some", "none"])
def test_l2_accumulate_sums_bit_identical_to_slot_order(cuda_device, n, k, d,
                                                        valid_mode):
    """Kernel row 2's sums equal its summation order rebuilt in plain
    float32 (``ref.distance_argmin_l2_acc_sums_ref``: slot s adds the rows
    of tiles s, s + slots, ... in row order from 0, then the slots in slot
    order) bit for bit, so one dropped or doubled row fails; counts
    exact; with no valid center every row is cluster 0's."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + k + d)
    x = torch.randn((n, d), generator=gen, device=cuda_device)
    c = torch.randn((k, d), generator=gen, device=cuda_device)
    valid = torch.arange(k, device=cuda_device) % 7 != 3
    if valid_mode == "none":
        valid[:] = False
    labels, d2, sums, cnt = tda.distance_argmin_l2_accumulate(x, c, valid)
    slots = min(tda.ACC_SLOTS, -(-n // tda.BN))
    want = tref.distance_argmin_l2_acc_sums_ref(x, labels, k, slots, tda.BN)
    assert torch.equal(sums, want)
    assert torch.equal(cnt, torch.bincount(labels.long(), minlength=k).float())
    if valid_mode == "none":
        assert not bool(labels.any()) and float(cnt[0]) == n


def test_l2_kernel_no_valid_center(cuda_device):
    x = torch.randn(70, 9, device=cuda_device)
    c = torch.randn(5, 9, device=cuda_device)
    lab, d2 = tda.distance_argmin_l2(x, c, torch.zeros(5, dtype=torch.bool,
                                                       device=cuda_device))
    assert int(lab.abs().max()) == 0
    assert bool((d2 == torch.finfo(torch.float32).max).all())


@pytest.mark.parametrize("layout", list(DEAD_TILE_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(300, 24), (1000, 128), (129, 300)])
def test_l2_kernels_on_dead_tile_layouts(cuda_device, layout, dtype, n, d):
    """Dead-tile skipping keeps the function: live centers as a prefix,
    leading dead tiles, a wholly dead tile between live ones, every center
    dead, k not a multiple of the tile; n not a multiple of the 128 rows a
    block, rows resident (d <= 256, aligned or not) or chunked (d = 300).
    Row 1 against the plain version; row 2's labels and d² equal row 1's
    bit for bit."""
    x, c, valid = dead_tile_layout(layout, n, d)
    tx = torch.from_numpy(x).to(cuda_device, dtype)
    tc = torch.from_numpy(c).to(cuda_device, dtype)
    tv = torch.from_numpy(valid).to(cuda_device)
    kl, kd = tda.distance_argmin_l2(tx, tc, tv)
    pl, pd = tref.distance_argmin_l2_ref(tx, tc, tv)
    if not valid.any():
        assert int(kl.abs().max()) == 0
        assert bool((kd == torch.finfo(torch.float32).max).all())
    else:
        xf, cf = tx.float().cpu().numpy(), tc.float().cpu().numpy()
        assert_labels_match(xf, cf, valid, pl.cpu().numpy(), kl.cpu().numpy(),
                            f"{layout} {n}x{d} {dtype}")
        scale = (xf * xf).sum(1) + (cf[valid] ** 2).sum(1).max()
        assert np.all(np.abs(kd.cpu().numpy() - pd.cpu().numpy())
                      <= 1e-5 * scale)
    labels, d2, _, cnt = tda.distance_argmin_l2_accumulate(tx, tc, tv)
    assert torch.equal(labels, kl) and torch.equal(d2, kd)
    assert float(cnt.sum()) == n


def test_fit_on_card_matches_cpu_fit(cuda_device):
    """Same injected draws: the card's fit (both kernels) gives the CPU
    fit's seeds bit for bit and its labels except at near-ties."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, 32))
    x = (centers[rng.integers(0, 8, 2000)]
         + 0.08 * rng.standard_normal((2000, 32))).astype(np.float32)
    x = np.round(x * 16) / 16         # exact products: identical ranks
    a = torch.from_numpy(np.round(rng.standard_normal((32, 16)) * 64) / 64
                         ).float()
    cfg = rt.GeekConfig(m=16, t=32, k_max=64, pair_cap=1 << 14)
    keys = _keys(rng, (cfg.silk_l + 1) * cfg.silk_k).reshape(
        cfg.silk_l + 1, cfg.silk_k, 2)
    cpu = rt.GEEK(cfg, bucketer=InjectedBucketer(a=a, table_keys=keys),
                  device="cpu")
    cpu.fit(rt.DenseData(x), 0)
    l2, mh = tda.distance_argmin_l2.launches, tmh.minhash_segments.launches
    card = rt.GEEK(cfg, bucketer=InjectedBucketer(
        a=a.to(cuda_device), table_keys=keys.to(cuda_device)))
    card.fit(rt.DenseData(x), 0)
    assert tda.distance_argmin_l2.launches == l2 + 1
    assert tmh.minhash_segments.launches == mh + cfg.silk_l
    cr, gr = cpu.result_, card.result_
    assert int(gr.k_star) == int(cr.k_star) > 0
    for f in ("group", "id", "valid"):
        np.testing.assert_array_equal(getattr(gr.seeds, f).cpu().numpy(),
                                      getattr(cr.seeds, f).numpy())
    assert_labels_match(x, cr.centers.numpy(), cr.center_valid.numpy(),
                        cr.labels.numpy(), gr.labels.cpu().numpy(), "card fit")
    labels, _ = rt.predict(card.model_, x)
    assert torch.equal(labels, gr.labels)


def test_reference_fixture_on_card(cuda_device):
    model = rt.restore_model(os.path.join(FIXTURE, "ckpt"))
    assert model.device.type == "cuda"
    q = np.load(os.path.join(FIXTURE, "queries.npy"))
    labels, _ = rt.predict(model, q)
    assert_labels_match(q, model.centers.cpu().numpy(),
                        model.center_valid.cpu().numpy(),
                        np.load(os.path.join(FIXTURE, "labels.npy")),
                        labels.cpu().numpy(), "fixture on card")


# the shapes of tests/test_kernels.py's Hamming sweeps
HAM_SHAPES = [(50, 4, 9, 5), (129, 17, 45, 20), (64, 8, 400, 1 << 15),
              (1000, 1024, 9, 12)]
PACKED_SHAPES = [(50, 4, 9, 4), (129, 17, 45, 8), (64, 8, 400, 16),
                 (33, 70, 7, 2), (300, 40, 64, 16)]


def _ham(rng, n, k, d, card):
    codes = rng.integers(0, card, (n, d)).astype(np.int32)
    c = rng.integers(0, card, (k, d)).astype(np.int32)
    codes[::3] = c[rng.integers(0, k, len(codes[::3]))]      # exact hits, ties
    return torch.from_numpy(codes), torch.from_numpy(c)


@pytest.mark.parametrize("n,k,d,card,case", [
    (*shape, "random") for shape in HAM_SHAPES] + [
    (300, None, d, None, case) for case in tref.EQUALITY_CASES
    for d in tref.EQUALITY_WIDTHS])
@pytest.mark.parametrize("valid_mode", ["some", "none"])
def test_hamming_kernel_bit_exact(cuda_device, n, k, d, card, case,
                                  valid_mode):
    if case == "random":
        rng = np.random.default_rng(n + k + d)
        codes, c = _ham(rng, n, k, d, card)
        some = torch.arange(k) % 7 != 3
    else:   # chip_smoke.py phase 6's edge cases (ref.EQUALITY_CASES)
        codes, c, some = tref.equality_case(case, d, n,
                                            torch.Generator().manual_seed(d))
        k = c.shape[0]
    valid = some if valid_mode == "some" else torch.zeros(k, dtype=torch.bool)
    before = tdh.distance_argmin_hamming.launches
    kl, kc = tdh.distance_argmin_hamming(codes.to(cuda_device),
                                         c.to(cuda_device),
                                         valid.to(cuda_device))
    assert tdh.distance_argmin_hamming.launches == before + 1
    pl, pc = tref.distance_argmin_hamming_ref(codes, c, valid)
    np.testing.assert_array_equal(kl.cpu().numpy(), pl.numpy())
    np.testing.assert_array_equal(kc.cpu().numpy(), pc.numpy())


@pytest.mark.parametrize("n,k,d,bits,case", [
    (*shape, "random") for shape in PACKED_SHAPES + [
        (70, 9, 11, b) for b in (1, 2, 4, 8, 16, 32)]] + [
    (300, None, None, b, case) for case in tpack.PACKED_CASES
    for b in (1, 2, 4, 8, 16, 32)])
def test_hamming_packed_kernel_bit_exact(cuda_device, n, k, d, bits, case):
    if case == "random":
        rng = np.random.default_rng(n * k + bits)
        hi = 2**32 if bits == 32 else 1 << bits
        codes = rng.integers(0, hi, (n, d), dtype=np.uint64).astype(np.uint32)
        c = rng.integers(0, hi, (k, d), dtype=np.uint64).astype(np.uint32)
        codes[::3] = c[0]
        codes[1, :] = hi - 1                    # words with the top bit set
        valid = np.arange(k) % 7 != 3
    else:   # chip_smoke.py phase 6's edge cases (pack.PACKED_CASES)
        codes, c, valid = (t.numpy() for t in tpack.packed_case(
            case, bits, n, torch.Generator().manual_seed(bits)))
        (n, d), k = codes.shape, c.shape[0]
    xp = tpack.pack_codes(carrier(codes), bits)
    cp = tpack.pack_codes(carrier(c), bits)
    assert d * bits < 32 or int(xp.min()) < 0
    valid = torch.from_numpy(valid)
    for dd in (d, None):
        kl, kc = tdh.distance_argmin_hamming_packed(
            xp.to(cuda_device), cp.to(cuda_device), valid.to(cuda_device),
            bits=bits, d=dd)
        pl, pc = tref.distance_argmin_hamming_packed_ref(xp, cp, valid,
                                                         bits=bits, d=dd)
        np.testing.assert_array_equal(kl.cpu().numpy(), pl.numpy())
        np.testing.assert_array_equal(kc.cpu().numpy(), pc.numpy())
    none = torch.zeros(k, dtype=torch.bool, device=cuda_device)
    kl, kc = tdh.distance_argmin_hamming_packed(
        xp.to(cuda_device), cp.to(cuda_device), none, bits=bits, d=d)
    assert int(kl.abs().max()) == 0 and bool((kc == d + 1).all())


def _code_fit(kind, device, draws):
    rng = np.random.default_rng(0)
    n, k = 3000, 8
    lab = rng.integers(0, k, n)
    if kind == "sparse":
        sets = np.where(rng.random((n, 20)) < 0.9,
                        rng.integers(0, 10**5, (k, 20))[lab],
                        rng.integers(0, 10**5, (n, 20))).astype(np.int32)
        data = rt.SparseData(sets, np.ones((n, 20), bool))
    else:
        x_num = (rng.standard_normal((k, 5))[lab]
                 + 0.05 * rng.standard_normal((n, 5))).astype(np.float32)
        x_cat = rng.integers(0, 12, (k, 4))[lab].astype(np.int32)
        data = rt.HeteroData(x_num, x_cat if kind == "hetero" else None)
    cfg = rt.GeekConfig(bucket_l=8, silk_l=3, k_max=64, pair_cap=1 << 14)
    est = rt.GEEK(cfg, device=device, bucketer=InjectedBucketer(
        **{key: v.to(device) for key, v in draws.items()}))
    est.fit(data, 0)
    return est, data


@pytest.mark.parametrize("kind", ["hetero", "hetero_num", "sparse"])
def test_code_fit_on_card_bit_identical_to_cpu(cuda_device, kind):
    """Same injected draws: the card's hetero/sparse fit (MinHash and
    Hamming kernels) equals the CPU fit bit for bit."""
    rng = np.random.default_rng(1)
    draws = {"item_keys": _keys(rng, 1),
             "sig_keys": _keys(rng, 24).reshape(8, 3, 2),
             "table_keys": _keys(rng, 12).reshape(4, 3, 2)}
    if kind == "sparse":
        draws["doph"] = _keys(rng, 1)
    cpu, _ = _code_fit(kind, "cpu", draws)
    kernel = (tdh.distance_argmin_hamming if kind == "hetero"
              else tdh.distance_argmin_hamming_packed)
    before, mh = kernel.launches, tmh.minhash_segments.launches
    card, data = _code_fit(kind, cuda_device, draws)
    assert kernel.launches == before + 1
    assert tmh.minhash_segments.launches == mh + 3
    cr, gr = cpu.result_, card.result_
    assert int(gr.k_star) == int(cr.k_star) > 0
    assert int(gr.overflow) == int(cr.overflow) == 0
    for f in ("labels", "dists", "centers", "center_valid", "radius"):
        np.testing.assert_array_equal(getattr(gr, f).cpu().numpy(),
                                      getattr(cr, f).numpy())
    labels, _ = card.predict(data)
    assert torch.equal(labels, gr.labels)


def test_code_fixtures_on_card(cuda_device):
    for name in ("geek_ref_hetero", "geek_ref_sparse"):
        path = os.path.join(DATA, name)
        model = rt.restore_model(os.path.join(path, "ckpt"))
        assert model.device.type == "cuda"
        if name == "geek_ref_hetero":
            labels, dists = rt.GEEK(rt.GeekConfig()).predict(
                rt.HeteroData(np.load(os.path.join(path, "x_num.npy")),
                              np.load(os.path.join(path, "x_cat.npy"))),
                model=model)
        else:
            labels, dists = rt.predict(model,
                                       np.load(os.path.join(path, "codes.npy")))
        np.testing.assert_array_equal(labels.cpu().numpy(),
                                      np.load(os.path.join(path, "labels.npy")))
        np.testing.assert_array_equal(dists.cpu().numpy(),
                                      np.load(os.path.join(path, "dists.npy")))


def test_card_entry_points_refuse_a_gloo_mesh(cuda_device, tmp_path):
    """On the card a gloo group is no mesh: the facade's sharded fit, the
    table-sync fit and restore_model raise instead of fitting on the
    CPU."""
    from _torch_dist import (SHARD_CFG, SYNC_CFG, blobs, exact_rows,
                             single_rank_group)
    x = blobs("dense", 200, 3)[0]
    with single_rank_group(tmp_path):
        mesh = rt.make_mesh()
        est = rt.GEEK(rt.GeekConfig(**SHARD_CFG))
        with pytest.raises(ValueError, match="needs a nccl mesh"):
            est.fit(rt.DenseData(x), 0, mesh=mesh)
        with pytest.raises(ValueError, match="needs a nccl mesh"):
            rt.make_fit_dense(mesh, rt.GeekConfig(**SYNC_CFG))(exact_rows(), 0)
        with pytest.raises(ValueError, match="needs a nccl mesh"):
            rt.restore_model(os.path.join(FIXTURE, "ckpt"), mesh=mesh)


def test_sharded_fits_on_one_rank_nccl_equal_incore(cuda_device, tmp_path):
    """On a one-rank NCCL group: the sharded dense, hetero and sparse fits
    equal the in-core fits on the card bit for bit, sharded predict
    equals predict, and the table-sync fit launches the accumulate kernel
    once per refine sweep."""
    import torch.distributed as dist

    from _torch_dist import SHARD_CFG, SYNC_CFG, blobs, exact_rows
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = rt.make_mesh()
        for kind, cls in (("dense", rt.DenseData), ("hetero", rt.HeteroData),
                          ("sparse", rt.SparseData)):
            data, fresh = cls(*blobs(kind, 1537, 0)), cls(*blobs(kind, 301, 9))
            est = rt.GEEK(rt.GeekConfig(**SHARD_CFG))
            model, res = est.fit(data, 1), est.result_
            m_s = est.fit(data, 1, mesh=mesh)
            r_s = est.result_
            for a, b in ((r_s.labels, res.labels), (r_s.dists, res.dists),
                         (m_s.centers, model.centers),
                         (m_s.radius, model.radius)):
                assert torch.equal(a, b), kind
            assert int(r_s.k_star) == int(res.k_star) > 0
            got = rt.make_predict_sharded(mesh)(m_s, *fresh.parts)
            want = est.predict(fresh, model=model)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        before = tda.distance_argmin_l2_accumulate.launches
        cfg = rt.GeekConfig(**SYNC_CFG, refine_sweeps=2)
        ts = rt.make_fit_dense(mesh, cfg)(exact_rows(), 0)
        assert tda.distance_argmin_l2_accumulate.launches == before + 2
        assert int(ts.k_star) > 0 and int(ts.overflow) == 0
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# flash attention and centroid attention
# ---------------------------------------------------------------------------

# tolerances: float32 at 2e-4, the reference's own sweep (online against
# two-pass softmax); bfloat16 at one bf16 ulp (2^-7 relative): kernel and
# plain version each round a float32 result once
FA_F32 = dict(rtol=2e-4, atol=2e-4)
FA_BF16 = dict(rtol=2.0**-7, atol=1e-6)
ATTN_SWEEP = [(1, 4, 4, 128, 32), (2, 8, 2, 100, 64), (1, 6, 1, 65, 64),
              (1, 2, 1, 70, 128), (1, 3, 3, 5, 20), (1, 16, 8, 2048, 64)]
CENTROID_SWEEP = [(1, 4, 4, 1, 48, 32), (2, 4, 2, 3, 100, 64),
                  (1, 3, 1, 40, 33, 16), (1, 16, 8, 1, 65, 64),
                  (1, 2, 1, 1, 200, 128)]


def _fa_close(got, want, dtype):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **(FA_F32 if dtype == torch.float32
                                             else FA_BF16))


@pytest.mark.parametrize("B,Hq,Hkv,S,dh", ATTN_SWEEP)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, B, Hq, Hkv, S, dh,
                                              causal, dtype):
    from repro_torch.kernels import flash_attention as tfa
    gen = torch.Generator(device=cuda_device).manual_seed(S * dh)
    q, k, v = (torch.randn((B, h, S, dh), generator=gen, device=cuda_device)
               .to(dtype) for h in (Hq, Hkv, Hkv))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    assert tfa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, Hq, S, dh)
    _fa_close(got, tref.attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("S", [1, 15, 65, 100])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_at_the_prefill_layout(cuda_device, S, dh,
                                                    causal):
    """The tensor-core routine at the prefill's layout: Qwen3-0.6B's 16
    query over 8 kv heads, (B, S, H, dh) bf16 seen transposed, ragged S
    down to one row."""
    from repro_torch.kernels import flash_attention as tfa
    gen = torch.Generator(device=cuda_device).manual_seed(S + dh)
    q = torch.randn((1, S, 16, dh), generator=gen, device=cuda_device)
    k, v = (torch.randn((1, S, 8, dh), generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = (t.bfloat16().transpose(1, 2) for t in (q, k, v))
    route = tfa.ROUTINES[torch.bfloat16]
    before = tfa.flash_attention.by_routine[route]
    got = tfa.flash_attention(q, k, v, causal=causal)
    assert tfa.flash_attention.by_routine[route] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (1, 16, S, dh)
    _fa_close(got, tref.attention_ref(q, k, v, causal=causal), torch.bfloat16)


def test_flash_attention_kernel_takes_strided_views(cuda_device):
    """The LM's (B, S, H, dh) layout, transposed, goes in as it is."""
    from repro_torch.kernels import flash_attention as tfa
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((1, 130, 4, 32), generator=gen, device=cuda_device)
    kv = torch.randn((1, 130, 2, 32), generator=gen, device=cuda_device)
    got = tfa.flash_attention(q.transpose(1, 2), kv.transpose(1, 2),
                              kv.transpose(1, 2))
    want = tref.attention_ref(q.transpose(1, 2).contiguous(),
                              kv.transpose(1, 2).contiguous(),
                              kv.transpose(1, 2).contiguous())
    _fa_close(got, want, torch.float32)


@pytest.mark.parametrize("B,Hq,Hkv,S,K,dh", CENTROID_SWEEP)
@pytest.mark.parametrize("dead", ["some", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_centroid_kernel_matches_plain(cuda_device, B, Hq, Hkv, S, K, dh, dead,
                                       dtype):
    """GQA, ragged S and K, 5 dead rows or all rows dead (the mean of the
    values), bf16 queries over float32 centroids (the decode step's mix)."""
    from repro_torch.kernels import flash_attention as tfa
    gen = torch.Generator(device=cuda_device).manual_seed(K * dh)
    q = torch.randn((B, Hq, S, dh), generator=gen, device=cuda_device).to(dtype)
    c, vc = (torch.randn((B, Hkv, K, dh), generator=gen, device=cuda_device)
             for _ in range(2))
    lm = torch.log1p(8.0 * torch.rand((B, Hkv, K), generator=gen,
                                      device=cuda_device))
    lm[..., (K - 5 if dead == "some" else 0):] = -1e30
    before = tfa.flash_centroid_attention.launches
    got = tfa.flash_centroid_attention(q, c, vc, lm)
    assert tfa.flash_centroid_attention.launches == before + 1
    assert got.dtype == dtype
    _fa_close(got, tref.centroid_attention_ref(q, c, vc, lm), dtype)
    if dead == "all":
        mean = vc.mean(2, keepdim=True).repeat_interleave(Hq // Hkv, 1)
        _fa_close(got, mean.expand_as(got).to(dtype), dtype)


def test_centroid_kernel_takes_broadcast_centroids(cuda_device):
    """Centroids shared across the batch (stride 0), as
    ``clustered_attention`` passes them."""
    from repro_torch.kernels import flash_attention as tfa
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q = torch.randn((3, 4, 1, 64), generator=gen, device=cuda_device)
    c, vc = (torch.randn((2, 20, 64), generator=gen, device=cuda_device)
             .expand(3, 2, 20, 64) for _ in range(2))
    lm = torch.zeros((2, 20), device=cuda_device).expand(3, 2, 20)
    _fa_close(tfa.flash_centroid_attention(q, c, vc, lm),
              tref.centroid_attention_ref(q, c.contiguous(), vc.contiguous(),
                                          lm.contiguous()), torch.float32)


def test_lm_paths_on_card_run_the_flash_kernels(cuda_device):
    """A smoke LM on the card: the prefill runs the flash-attention kernel
    once per layer and equals the same forward on the CPU; clustered decode
    runs the centroid-attention kernel once per layer per step, and k* per head equals the CPU run's (the same
    draws: the fits' seeds are the generator's on each device, so both are
    handed one bucketer's arrays). float32 products stay full float32
    (``forward`` turns TF32 off)."""
    import dataclasses

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import model as tm
    from repro_torch.serve import kv_cluster as tkv
    cfg = dataclasses.replace(rt.get_arch("qwen3_0_6b", smoke=True),
                              num_layers=2)
    cpu = tm.init_params(cfg, 0, device="cpu")
    card = _to(cpu, cuda_device)
    tok = torch.randint(0, cfg.vocab_size, (1, 90),
                        generator=torch.Generator().manual_seed(0))
    before = tfa.flash_attention.launches
    lc, _ = tm.prefill_step(card, cfg, tok[:, :80].to(cuda_device))
    assert tfa.flash_attention.launches == before + cfg.num_layers
    assert not torch.backends.cuda.matmul.allow_tf32
    lp, _ = tm.prefill_step(cpu, cfg, tok[:, :80])
    np.testing.assert_allclose(lc.cpu().numpy(), lp.numpy(), rtol=1e-4,
                               atol=1e-4 * float(lp.abs().max()))
    rng = np.random.default_rng(0)
    a = rng.standard_normal((cfg.resolved_head_dim, 16)).astype(np.float32)
    keys = rng.integers(0, 2**32, (6, 3, 2), dtype=np.uint64).astype(np.uint32)

    def draws(device):
        return lambda layer, h, fits: InjectedBucketer(
            a=torch.from_numpy(a).to(device), table_keys=carrier(keys).to(device))

    gcfg = tkv.default_kv_config(16)
    before = tfa.flash_centroid_attention.launches
    on_card = tkv.clustered_decode(card, cfg, tok, 80, gcfg=gcfg,
                                   refresh_every=6, draws=draws(cuda_device))
    assert tfa.flash_centroid_attention.launches == \
        before + cfg.num_layers * 10
    on_cpu = tkv.clustered_decode(cpu, cfg, tok, 80, gcfg=gcfg,
                                  refresh_every=6, draws=draws("cpu"),
                                  device="cpu")
    assert on_card["k_stars"] == on_cpu["k_stars"]
    assert min(on_card["k_stars"]) > 0 and max(on_card["overflows"]) == 0
    assert on_card["ppl"] == pytest.approx(on_cpu["ppl"], rel=1e-3)


def _to(tree, device):
    """A parameter tree (dicts and lists of tensors) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


# ---------------------------------------------------------------------------
# the clustered decode step: head-batched route, decode routine, CUDA graph
# ---------------------------------------------------------------------------

# (heads, n, k, d): the decode step's (8 kv heads, one row, k_max 64, dh
# 64), dead tiles among 1,024 centers, ragged tiles, unresident d
HEADS_SHAPES = [(8, 1, 64, 64), (3, 300, 70, 24), (2, 130, 1024, 128),
                (2, 50, 70, 960)]


@pytest.mark.parametrize("H,n,k,d", HEADS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_heads_kernel_bit_identical_to_per_head_launches(cuda_device, H, n,
                                                            k, d, dtype):
    """One head-batched launch gives each head the labels and d² of one
    launch on that head, bit for bit: ties to the first index within each
    head (a duplicated center), a head with no valid center, dead tiles."""
    gen = torch.Generator(device=cuda_device).manual_seed(H * n + k + d)
    x = torch.randn((H, n, d), generator=gen, device=cuda_device).to(dtype)
    c = torch.randn((H, k, d), generator=gen, device=cuda_device).to(dtype)
    c[:, 9] = c[:, 3]
    x[:, 0] = c[:, 3]
    valid = torch.rand((H, k), generator=gen, device=cuda_device) < 0.7
    valid[:, [3, 9]] = True
    if k > 128:
        valid[:, 64:128] = False                    # a dead 64-center tile
    valid[-1] = False
    cf = c.float()
    csq = torch.sum(cf * cf, dim=-1)
    before = (tda.distance_argmin_l2_heads.launches,
              tda.distance_argmin_l2.launches)
    labels, d2 = tda.distance_argmin_l2_heads(x, c, csq, valid)
    for h in range(H):
        lab, dd = tda.distance_argmin_l2(x[h], c[h], valid[h])
        assert torch.equal(labels[h], lab), h
        assert torch.equal(d2[h], dd), h
    assert (tda.distance_argmin_l2_heads.launches,
            tda.distance_argmin_l2.launches) == (before[0] + 1,
                                                 before[1] + H)
    assert int(labels[0, 0]) == 3
    assert not bool(labels[-1].any())
    assert bool((d2[-1] == torch.finfo(torch.float32).max).all())


# (B, Hq, Hkv, K, dh): the main path's (k_max 64), k_max + 1 = 129 rows of
# dh 128, a group of one and of four, two batch rows, a second pass of rows
DECODE_SWEEP = [(1, 16, 8, 64, 64), (1, 4, 4, 128, 128), (2, 8, 2, 33, 32),
                (1, 6, 2, 300, 16)]


@pytest.mark.parametrize("B,Hq,Hkv,K,dh", DECODE_SWEEP)
@pytest.mark.parametrize("case", ["dead", "all_dead", "no_extra"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_centroid_decode_kernel_matches_plain(cuda_device, B, Hq, Hkv, K, dh,
                                              case, dtype):
    """The decode routine against its plain version: the state read in
    place, centroids dead by validity or by zero mass, all dead (with the
    fresh row: its value; without: the mean of the value centroids),
    queries and fresh rows in the layer layout (strided views)."""
    from repro_torch.kernels import flash_attention as tfa
    gen = torch.Generator(device=cuda_device).manual_seed(K * dh + B)
    c, vc = (torch.randn((Hkv, K, dh), generator=gen, device=cuda_device)
             for _ in range(2))
    mass = torch.randint(0, 4, (Hkv, K), generator=gen,
                         device=cuda_device).float()
    valid = torch.rand((Hkv, K), generator=gen, device=cuda_device) < 0.8
    if case == "all_dead":
        valid[:] = False
    qkv = torch.randn((B, 1, Hq + 2 * Hkv, dh), generator=gen,
                      device=cuda_device).to(dtype)
    q, ek, ev = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    extras = {} if case == "no_extra" else {"extra_k": ek, "extra_v": ev}
    before = (tfa.flash_centroid_decode.launches,
              tfa.flash_centroid_attention.launches)
    got = tfa.flash_centroid_decode(q, c, vc, mass, valid, **extras)
    assert (tfa.flash_centroid_decode.launches,
            tfa.flash_centroid_attention.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert got.dtype == dtype and got.shape == (B, 1, Hq, dh)
    want = tref.centroid_decode_ref(q, c, vc, mass, valid, **extras)
    _fa_close(got, want, dtype)
    if case == "all_dead":
        mean = ev if extras else vc.mean(1)[None, None].expand(B, 1, Hkv,
                                                                dh)
        _fa_close(got, mean.repeat_interleave(Hq // Hkv, 2).to(dtype), dtype)


def test_clustered_decode_graph_replay_equals_eager_step(cuda_device):
    """A 2-layer smoke LM decoded on the card with the clustered step
    captured as a CUDA graph and replayed, against the same run with the
    step eager: the same perplexity, k* and refreshes; the decode routine
    and the absorb kernel counted once a layer a step in both (replays
    counted), the head-batched route not at all."""
    import dataclasses

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.serve import kv_cluster as tkv
    cfg = dataclasses.replace(rt.get_arch("qwen3_0_6b", smoke=True),
                              num_layers=2)
    params = rt.init_params(cfg, 0, device=cuda_device)
    tok = torch.randint(0, cfg.vocab_size, (1, 100),
                        generator=torch.Generator().manual_seed(3))
    runs = {}
    for graph in (True, False):
        before = (tfa.flash_centroid_decode.launches,
                  tda.l2_absorb_heads.launches,
                  tda.distance_argmin_l2_heads.launches)
        runs[graph] = tkv.clustered_decode(
            params, cfg, tok, 80, gcfg=tkv.default_kv_config(16),
            refresh_every=8, cuda_graph=graph)
        assert (tfa.flash_centroid_decode.launches - before[0],
                tda.l2_absorb_heads.launches - before[1],
                tda.distance_argmin_l2_heads.launches - before[2]) == (
                    cfg.num_layers * 20, cfg.num_layers * 20, 0)
    replayed, eager = runs[True], runs[False]
    assert replayed["k_stars"] == eager["k_stars"]
    assert replayed["refreshes"] == eager["refreshes"] == \
        2 * cfg.num_kv_heads * cfg.num_layers
    assert replayed["ppl"] == eager["ppl"]
    assert len(replayed["seconds"]["steps"]) == 20


# ---------------------------------------------------------------------------
# the decode step's absorb: route + EMA of one layer's kv heads, one launch
# ---------------------------------------------------------------------------

# (kv heads, k_max, d): the decode step's, a ragged k_max with small d, a
# wide d
ABSORB_SHAPES = [(8, 64, 64), (2, 33, 32), (4, 128, 128)]
ABSORB_EMA = 0.1
ABSORB_STATE = ("centers", "v_cent", "radius", "v_radius", "mass",
                "center_valid", "v_max")


def _absorb_rtol(d):
    """radius, v_radius and v_max, relative: norms of d float32 squares
    summed in the kernel's order and in torch's; two sums of d
    non-negative terms lie within 2(d - 1)·2⁻²⁴ of each other, the square
    root halves that, and the add rounds once more: (d + 2)·2⁻²⁴."""
    return (d + 2) * 2.0**-24


def _absorb_inputs(dev, H, K, d, dtype, seed):
    """(keys, values (H, 1, d) views of one projection in ``dtype``, the
    state by name): dead rows (one at its head's key), a tie on head 0
    (label 2), a hit on head 1's last row (H > 2), no valid center on the
    last head (label 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = dict(generator=gen, device=dev)
    c, vc = (torch.randn((H, K, d), **f) for _ in range(2))
    valid = torch.rand((H, K), **f) < 0.8
    rows = torch.randn((1, 1, 2 * H, d), **f).to(dtype)
    keys, values = rows[0, :, :H].transpose(0, 1), rows[0, :, H:].transpose(0, 1)
    c[0, 5] = c[0, 2]
    valid[0, [2, 5]] = True
    keys[0, 0] = c[0, 2] + 0.01 * torch.randn((d,), **f)
    if H > 2:
        valid[1, K - 1] = True
        keys[1, 0] = c[1, K - 1] + 0.01 * torch.randn((d,), **f)
    valid[:, 7] = False
    c[:, 7] = keys[:, 0].float()
    valid[H - 1] = False
    mass = torch.where(valid, torch.randint(1, 600, (H, K), **f).float(), 0.0)
    state = {"centers": c, "v_cent": vc,
             "radius": 3 * torch.rand((H, K), **f),
             "v_radius": 3 * torch.rand((H, K), **f), "mass": mass,
             "center_valid": valid, "v_max": 4 * torch.rand((H,), **f)}
    return keys, values, state


@pytest.mark.parametrize("H,K,d", ABSORB_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_absorb_kernel_matches_route_and_plain_ema(cuda_device, H, K, d,
                                                   dtype):
    """One absorb launch: labels and d² equal the head-batched route's bit
    for bit (ties to the first index, a dead row at the key skipped, label
    0 without a valid center); centers, v_cent and mass equal the plain
    EMA's on the card bit for bit (``kv_cluster.absorb_plain`` on a copy
    of the state); radius, v_radius and v_max within ``_absorb_rtol``."""
    from repro_torch.serve import kv_cluster as tkv
    keys, values, state = _absorb_inputs(cuda_device, H, K, d, dtype,
                                          H * K + d)
    fused = {n: t.clone() for n, t in state.items()}
    plain = {n: t.clone() for n, t in state.items()}
    c = state["centers"]
    csq = torch.sum(c * c, dim=-1)
    decay = torch.pow(1.0 - ABSORB_EMA, torch.ones((1,), device=cuda_device))
    before = tda.l2_absorb_heads.launches
    lab, d2 = tda.l2_absorb_heads(keys, values,
                                  *(fused[n] for n in ABSORB_STATE), csq,
                                  decay)
    torch.cuda.synchronize()
    assert tda.l2_absorb_heads.launches == before + 1
    assert lab.shape == d2.shape == (H, 1)
    hl, hd = tda.distance_argmin_l2_heads(keys.float(), c, csq,
                                          state["center_valid"])
    assert torch.equal(lab, hl) and torch.equal(d2, hd)
    assert int(lab[0, 0]) == 2 and int(lab[H - 1, 0]) == 0
    if H > 2:
        assert int(lab[1, 0]) == K - 1
    pl, _ = tkv.absorb_plain(keys, values, *(plain[n] for n in ABSORB_STATE),
                             csq, ema=ABSORB_EMA)
    assert torch.equal(pl, lab)
    for n in ("centers", "v_cent", "mass", "center_valid"):
        assert torch.equal(fused[n], plain[n]), n
    for n in ("radius", "v_radius", "v_max"):
        rel = (fused[n] - plain[n]).abs() / plain[n].abs().clamp(min=1e-30)
        assert float(rel.max()) <= _absorb_rtol(d), n


def test_absorb_graph_replay_equals_eager(cuda_device):
    """``LayerKVCluster.absorb`` of one row a head captured in a CUDA graph
    (``kv_cluster._Replay``: one eager call, the capture) and replayed
    once, against two eager calls on a copy of the state: the same bits;
    the replay counted as one launch."""
    from repro_torch.serve import kv_cluster as tkv
    keys, values, state = _absorb_inputs(cuda_device, 8, 64, 64,
                                         torch.bfloat16, 5)
    layers = []
    for _ in range(2):
        lay = tkv.LayerKVCluster(8, 64, tkv.default_kv_config(64),
                                 ema=ABSORB_EMA, device=cuda_device)
        for n in ABSORB_STATE:
            getattr(lay, n).copy_(state[n])
        layers.append(lay)
    eager, graphed = layers
    want = [eager.absorb(keys, values) for _ in range(2)][-1]
    replay = tkv._Replay(lambda: graphed.absorb(keys, values))
    before = tda.l2_absorb_heads.launches
    got = replay()
    torch.cuda.synchronize()
    assert tda.l2_absorb_heads.launches == before + 1
    assert torch.equal(got, want)
    for n in ABSORB_STATE:
        assert torch.equal(getattr(graphed, n), getattr(eager, n)), n


def _code_model(device, impl, k=64, d=16, seed=0):
    """A Hamming model with a narrow index (bucket 4) and queries, on
    ``device``: half the queries copies of centers."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 16, (k, d)).astype(np.int32)
    x = rng.integers(0, 16, (2000, d)).astype(np.int32)
    x[::2] = c[rng.integers(0, k, 1000)]
    valid = np.arange(k) % 9 != 4
    model = tm.build_model(
        torch.from_numpy(c).to(device), torch.from_numpy(valid).to(device),
        torch.tensor(int(valid.sum())).to(device), torch.zeros(k).to(device),
        metric="hamming", impl=impl, code_bits=4, index_tables=4,
        index_bucket=4)
    return model, torch.from_numpy(x).to(device)


@pytest.mark.parametrize("impl", ["equality", "packed", "onehot"])
def test_probed_hamming_predict_on_card_equals_plain(cuda_device, impl):
    """The index and the probed predict on the card are the CPU's bits;
    the empty-probe fallback launches the card's kernel."""
    gpu, xg = _code_model(cuda_device, impl)
    cpu, xc = _code_model("cpu", impl)
    for a, b in ((gpu.center_index.sorted_keys, cpu.center_index.sorted_keys),
                 (gpu.center_index.sorted_ids, cpu.center_index.sorted_ids)):
        assert torch.equal(a.cpu(), b)
    for p in (0, 1):
        for g, c in zip(rt.predict(gpu, xg, probes=p),
                        rt.predict(cpu, xc, probes=p)):
            assert torch.equal(g.cpu(), c)


def test_probed_l2_predict_on_card_holds_the_property(cuda_device):
    rng = np.random.default_rng(1)
    c = rng.standard_normal((300, 32)).astype(np.float32)
    x = (c[rng.integers(0, 300, 3000)]
         + 0.3 * rng.standard_normal((3000, 32))).astype(np.float32)
    model = tm.build_model(
        torch.from_numpy(c).to(cuda_device),
        torch.ones(300, dtype=torch.bool, device=cuda_device),
        torch.tensor(300).to(cuda_device), torch.zeros(300).to(cuda_device),
        metric="l2", index_tables=8, index_bucket=8)
    xg = torch.from_numpy(x).to(cuda_device)
    exact, _ = rt.predict(model, xg)
    lab, dst = rt.predict(model, xg, probes=1)
    cand, mask = tm.probe_candidates(model.center_index, xg, 1)
    hit = ((cand == exact[:, None].long()) & mask).any(1).cpu().numpy()
    assert_labels_match(x[hit], c, np.ones(300, bool),
                        exact.cpu().numpy()[hit], lab.cpu().numpy()[hit],
                        "probed l2 on the card")
    assert bool(torch.isfinite(dst).all())


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_streamed_fit_on_card_equals_incore(cuda_device, kind):
    """fit(chunk=) on the card (pinned chunks on a copy stream) equals the
    in-core fit on the card, bit for bit, and the pass runs the kernels."""
    rng = np.random.default_rng(2)
    if kind == "dense":
        c = 3.0 * rng.standard_normal((8, 24))
        parts = ((c[rng.integers(0, 8, 5000)]
                  + 0.2 * rng.standard_normal((5000, 24))).astype(np.float32),)
        data = rt.DenseData
    else:
        sets = rng.integers(0, 10**5, (8, 20))[rng.integers(0, 8, 5000)]
        parts = (sets.astype(np.int32), np.ones((5000, 20), bool))
        data = rt.SparseData
    cfg = rt.GeekConfig(m=16, t=32, k_max=64, pair_cap=1 << 14)
    est = rt.GEEK(cfg)
    model = est.fit(data(*parts), 0)
    want = est.result_
    smodel = est.fit(data(*parts), 0, chunk=1100)
    got = est.result_
    assert est.stream_peak_bytes_ is not None
    for f in ("labels", "dists"):
        assert torch.equal(getattr(got, f), getattr(want, f).cpu())
    assert torch.equal(smodel.radius, model.radius)
    assert torch.equal(smodel.centers, model.centers)
    lab, _ = est.predict(data(*parts), batch=777, probes=1)
    assert torch.equal(lab, est.predict(data(*parts), probes=1)[0].cpu())


def _served(server, x, sizes):
    """Submit ``sizes`` requests of consecutive rows; (labels, dists)."""
    futs, off = [], 0
    for n in sizes:
        futs.append(server.submit(x[off:off + n]))
        off += n
    got = [f.result(timeout=120) for f in futs]
    return (np.concatenate([g.labels for g in got]),
            np.concatenate([g.dists for g in got]), off)


@pytest.mark.parametrize("probes", [None, 1])
def test_cluster_server_on_card_equals_predict(cuda_device, probes,
                                               monkeypatch):
    """A short exact (and probed) ClusterServer run on the card: labels
    equal predict on the same rows in one call, distances within 1e-6
    relative, the L2 kernel launched by the server; with no card a server
    asked for no device raises instead of serving on the CPU."""
    from repro_torch.serve import ClusterServer
    rng = np.random.default_rng(0)
    c = rng.standard_normal((24, 32))
    x = (c[rng.integers(0, 24, 6000)]
         + 0.1 * rng.standard_normal((6000, 32))).astype(np.float32)
    model = rt.GEEK(rt.GeekConfig(k_max=128, pair_cap=1 << 16)).fit(
        rt.DenseData(x), 0)
    sizes = (1, 7, 300, 512, 33, 1000, 64, 2)
    with ClusterServer(model, probes=probes, max_batch=1024,
                       min_bucket=16) as server:
        assert server.device.type == "cuda"
        server.warmup(x[:16])
        before = tda.distance_argmin_l2.launches
        labels, dists, n = _served(server, x, sizes)
        launched = tda.distance_argmin_l2.launches - before
        st = server.stats()
    want_l, want_d = rt.predict(model, x[:n], probes=probes)
    np.testing.assert_array_equal(labels, want_l.cpu().numpy())
    np.testing.assert_allclose(dists, want_d.cpu().numpy(), rtol=1e-6,
                               atol=0)
    assert st["failed"] == 0
    if probes is None:
        assert launched >= st["batches"] >= 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterServer(model)


def test_baselines_on_card_launch_the_kernels(cuda_device):
    """seed_then_assign and Lloyd launch the L2 kernel, k-modes the
    equality kernel; k-modes equals its plain path bit for bit."""
    from repro_torch.core import assign as tassign
    from repro_torch.core import baselines as tb
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((5000, 16)).astype(np.float32)
                         ).to(cuda_device)
    before = tda.distance_argmin_l2.launches
    res = tb.seed_then_assign(x, 32, 0)
    tb.lloyd(x, 32, 0, iters=3)
    assert tda.distance_argmin_l2.launches - before == 1 + 4
    lab_p, d2_p = tassign.assign_l2(x, res.centers, res.center_valid)
    assert_labels_match(x.cpu().numpy(), res.centers.cpu().numpy(),
                        np.ones(32, bool), lab_p.cpu().numpy(),
                        res.labels.cpu().numpy(), "seed_then_assign on card")
    codes = torch.from_numpy(rng.integers(0, 5, (5000, 9)).astype(np.int32)
                             ).to(cuda_device)
    before = tdh.distance_argmin_hamming.launches
    got = tb.kmodes(codes, 16, 3, iters=4)
    assert tdh.distance_argmin_hamming.launches - before == 5
    idx = tb.random_indices(5000, 16, torch.Generator(
        device=cuda_device).manual_seed(3))
    plain = tb._kmodes_iterate(codes.cpu(), codes[idx].cpu(), 4)
    for name in ("labels", "centers", "center_valid", "dists"):
        assert torch.equal(getattr(got, name).cpu(), getattr(plain, name))


# ---------------------------------------------------------------------------
# training: the kernels are forward only; the train step on the card
# ---------------------------------------------------------------------------

def test_flash_kernels_refuse_inputs_that_require_grad(cuda_device):
    """Every flash entry a model forward reaches raises on an input that
    requires grad while grad mode is on (its output would be cut off from
    the graph), and runs under ``torch.no_grad()``."""
    from repro_torch.kernels import flash_attention as tfa
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((1, 4, 16, 32), generator=gen, device=cuda_device)
    k, v = (torch.randn((1, 2, 16, 32), generator=gen, device=cuda_device)
            for _ in range(2))
    lm = torch.zeros((1, 2, 16), device=cuda_device)
    for args, fn in (((q, k, v), tops.flash_attention),
                     ((q, k, v), tfa.flash_attention),
                     ((q, k, v, lm), tfa.flash_centroid_attention)):
        before = tfa.flash_attention.launches
        with pytest.raises(RuntimeError, match="forward only"):
            fn(args[0].clone().requires_grad_(), *args[1:])
        assert tfa.flash_attention.launches == before
        with torch.no_grad():
            fn(args[0].clone().requires_grad_(), *args[1:])
    c = torch.randn((2, 16, 32), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        tfa.flash_centroid_decode(q[:, :, :1].transpose(1, 2), c, c.detach(),
                                  torch.ones((2, 16), device=cuda_device),
                                  torch.ones((2, 16), dtype=torch.bool,
                                             device=cuda_device))


def test_train_step_on_card_matches_cpu(cuda_device):
    """One AdamW step of a float32 smoke model on the card against the
    same step on the CPU (float32 products in full float32, ``forward``
    turns TF32 off): loss and grad norm within 1e-4 relative; the updated
    parameters within 1e-3 lr on average, at most 1e-3 of the elements
    more than lr / 100 apart and none more than 2 lr (AdamW's step is
    about ±lr wherever a gradient is well above eps, and where one is as
    small as eps the two devices' steps may differ by their sizes;
    ``tests/test_torch_train.py``)."""
    import dataclasses

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as tm
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(rt.get_arch("qwen3_0_6b", smoke=True),
                              dtype="float32")
    cpu = tm.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
             for k in ("inputs", "labels")}
    opt = adamw(1e-3)
    step = make_train_step(cfg, opt, grad_accum=2)
    out_c = step(cpu, opt.init(cpu), 0, batch)
    card = _to(cpu, cuda_device)
    out_g = step(card, opt.init(card), 0,
                 {k: v.to(cuda_device) for k, v in batch.items()})
    for name in ("loss", "grad_norm"):
        assert float(out_g[3][name]) == pytest.approx(
            float(out_c[3][name]), rel=1e-4)
    far = total = 0
    for got, want in zip(tm.leaves(out_g[0]), tm.leaves(out_c[0])):
        err = (got.cpu() - want).abs()
        assert float(err.max()) <= 2e-3 and float(err.mean()) <= 1e-6
        far += int((err > 1e-5).sum())
        total += err.numel()
    assert far <= 1e-3 * total


# ---------------------------------------------------------------------------
# the MoE, Mamba and RWKV6 blocks; the trainer's mesh mode
# ---------------------------------------------------------------------------

#: (block, smoke config): the MoE feed-forward and the Mamba mixer of
#: Jamba's smoke, RWKV6's time and channel mixes
BLOCKS = [("moe", "jamba_v0_1_52b"), ("mamba", "jamba_v0_1_52b"),
          ("rwkv", "rwkv6_1_6b")]


def _block(name, p, x, cfg):
    """The block's output(s) on x (B, S, d), float32."""
    from repro_torch.models import moe, rwkv6, ssm
    if name == "moe":
        y, aux = moe.moe_apply(p, x, cfg)
        return [y.float(), aux.float().reshape(1)]
    if name == "mamba":
        return [ssm.mamba_apply(p, x, cfg)[0].float()]
    y, _ = rwkv6.rwkv_time_mix(p, x, cfg)
    return [y.float(), rwkv6.rwkv_channel_mix(p, x)[0].float()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,arch", BLOCKS)
def test_moe_mamba_rwkv_blocks_on_card_match_cpu(cuda_device, name, arch,
                                                 dtype):
    """Each block's forward on the card against the same block on the CPU
    (S = 128: Mamba's scan in one chunk, RWKV6's chunked WKV): float32
    within 1e-4 of the output's largest magnitude, bf16 within 2^-5 of it
    (a few bf16 ulps: each device rounds its products and casts apart).
    bf16 MoE runs on the CPU's routes (``MoERoutes``, near ties counted),
    float32 MoE must choose them."""
    import dataclasses

    from _torch_parity import MoERoutes
    from repro_torch.models import moe, rwkv6, ssm
    from repro_torch.models.layers import dtype_of
    cfg = dataclasses.replace(rt.get_arch(arch, smoke=True), dtype=dtype)
    init = {"moe": moe.moe_init, "mamba": ssm.mamba_init,
            "rwkv": rwkv6.rwkv_init}[name]
    cpu = init(torch.Generator().manual_seed(0), cfg, "cpu")
    card = _to(cpu, cuda_device)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32)).to(dtype_of(cfg))
    routes = MoERoutes()
    with routes.record() if name == "moe" else contextlib.nullcontext():
        want = _block(name, cpu, x, cfg)
    with routes.port(inject=dtype == "bfloat16") if name == "moe" else \
            contextlib.nullcontext():
        got = _block(name, card, x.to(cuda_device), cfg)
    tol = 1e-4 if dtype == "float32" else 2.0**-5
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= tol * float(w.abs().max()), name


def test_mesh_mode_train_step_on_one_rank_nccl(cuda_device, tmp_path):
    """The trainer's mesh mode (``--mesh 1x1``, DTensors on a (data,
    model) DeviceMesh of a one-rank NCCL group) against the single-card
    trainer from the same weights, float32 smoke model, 2 AdamW steps:
    losses and grad norms within 1e-5 relative, parameters as
    ``test_train_step_on_card_matches_cpu`` counts them."""
    import torch.distributed as dist

    from _torch_dist import MESH_ARGS
    from repro_torch.launch import train as ttrain
    from repro_torch.models.sharding import value
    torch.cuda.set_device(0)
    argv = [a for a in MESH_ARGS if a not in ("--device", "cpu")] + \
        ["--device", "cuda"]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        cfg = rt.get_arch("qwen3_0_6b", smoke=True)
        weights = rt.init_params(cfg, 0, device=cuda_device)
        runs = [ttrain.train(ttrain.build_parser().parse_args(argv + extra),
                             params=weights, log=lambda _: None)
                for extra in ([], ["--mesh", "1x1"])]
        single, mesh = runs
        for k in ("losses", "grad_norms"):
            assert mesh[k] == pytest.approx(single[k], rel=1e-5), k
        far = total = 0
        from repro_torch.utils.tree import tree_leaves
        for got, want in zip(tree_leaves(mesh["params"]),
                             tree_leaves(single["params"])):
            err = (value(got) - want).abs()
            assert float(err.max()) <= 4e-3 and float(err.mean()) <= 1e-6
            far += int((err > 1e-5).sum())
            total += err.numel()
        assert far <= 1e-3 * total
    finally:
        dist.destroy_process_group()


def test_mesh_step_on_four_cards_matches_one_card(cuda_device, tmp_path):
    """The mesh step on a (2, 2) ("data", "model") NCCL mesh of four cards
    (``_torch_dist.mesh_card_outputs``): every attention score mode,
    Mamba's channels and the experts cut over "model", each config's
    float32 smoke step 1 against the same step on one card: the loss
    within 1e-5 relative, the gradients within 5e-5 of each leaf's
    largest magnitude (``test_torch_mesh_train.py`` holds the same modes
    on gloo CPU ranks against the reference's pjit step)."""
    import _torch_dist
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: a (2, 2) mesh of cards")
    out = _torch_dist.run_ranks(_torch_dist.mesh_card_outputs, 4,
                                str(tmp_path), timeout=600, backend="nccl")
    for arch, (loss, one, worst) in out[0].items():
        assert loss == pytest.approx(one, rel=1e-5), arch
        assert worst <= 5e-5, arch
