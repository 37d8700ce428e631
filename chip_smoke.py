#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the main
path (``GEEK(cfg).fit(DenseData(x), seed)`` then ``predict``) at the
ANN_SIFT1M base set's shape (1,000,000 x 128 float32 vectors, generated,
not downloaded), checks that the path launched both kernels, round-trips
checkpoints, and reproduces the labels of a model fitted and saved by the
JAX reference (``tests/data/geek_ref_dense``). Any failure raises and
exits non-zero. The line before the last is a JSON object with each
kernel's launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.

Imports only torch, numpy, the standard library and ``repro_torch``.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "geek_ref_dense")

# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

N_FIT, N_FRESH, D, K_TRUE = 1_000_000, 65_536, 128, 64
L2_SHAPES = [(64, 8, 16), (130, 33, 70), (257, 128, 128), (100, 5, 960)]
MH_SHAPES = [(10, 8, 1), (100, 64, 3), (33, 17, 5)]
# d² tolerance, relative to the expansion's scale ‖x‖² + max‖c‖²: about
# 170 float32 ulps, above either side's rounding, far below a real gap
L2_RTOL = 1e-5


def phase(name):
    print(f"== {name}", flush=True)


def cuda_ms(fn, iters):
    """Mean ms of ``fn`` over ``iters`` back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def l2_agreement(x, c, valid, kernel, plain):
    """(near-tie rows, max |d² kernel - d² plain|); raises on a label
    disagreement beyond a near-tie or a d² outside the tolerance."""
    (lk, dk), (lp, dp) = kernel, plain
    xf, cf = x.float(), c.float()
    tol = L2_RTOL * ((xf * xf).sum(1) + (cf[valid] ** 2).sum(1).max())
    err = (dk - dp).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"d² off by up to {float(err.max())}")
    rows = (lk != lp).nonzero().flatten()
    x64 = xf[rows].double()
    da = ((x64 - cf[lk[rows].long()].double()) ** 2).sum(1)
    db = ((x64 - cf[lp[rows].long()].double()) ** 2).sum(1)
    bad = rows[(da - db).abs() > tol[rows]]
    if bad.numel():
        raise AssertionError(f"labels disagree beyond near-ties at rows "
                             f"{bad[:10].tolist()}")
    return int(rows.numel()), float(err.max())


def purity(labels, truth, k_max):
    joint = torch.bincount(labels.long() * K_TRUE + truth.long(),
                           minlength=k_max * K_TRUE).view(k_max, K_TRUE)
    return float(joint.max(1).values.sum()) / labels.numel()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch as rt
    from repro_torch.data.synthetic import sift_like
    from repro_torch.kernels import build
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import minhash_buckets as mh
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    # float32 products in full float32: a TF32 x @ a would move QALSH ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 build")
    secs = build.build()
    print(f"built {list(build.SOURCES)} in {secs:.2f} s (nvcc, sm_90a)")
    for name, log in build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device=dev).manual_seed(0)

    phase("2 L2 kernel vs plain")
    l2_err = 0.0
    for n, k, d in L2_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
            c = torch.randn((k, d), generator=gen, device=dev).to(dtype)
            valid = torch.arange(k, device=dev) % 7 != 3
            ties, err = l2_agreement(x, c, valid,
                                     da.distance_argmin_l2(x, c, valid),
                                     ref.distance_argmin_l2_ref(x, c, valid))
            l2_err = max(l2_err, err)
            print(f"  ({n},{k},{d}) {str(dtype)[6:]}: near-ties {ties}, "
                  f"max |Δd²| {err:.3g}")
    data = sift_like(gen, n=N_FIT + N_FRESH, k=K_TRUE)
    x_fit, x_new = data.x[:N_FIT], data.x[N_FIT:]
    c = x_fit[torch.randperm(N_FIT, generator=gen, device=dev)[:1024]]
    valid = torch.arange(1024, device=dev) % 7 != 3
    ties, err = l2_agreement(x_fit, c, valid,
                             da.distance_argmin_l2(x_fit, c, valid),
                             ref.distance_argmin_l2_ref(x_fit, c, valid))
    l2_err = max(l2_err, err)
    print(f"  ({N_FIT},1024,{D}) float32: near-ties {ties}, "
          f"max |Δd²| {err:.3g}")

    phase("3 MinHash kernel vs plain (bit-exact)")

    def keys_for(K):
        k = torch.randint(0, 1 << 32, (K, 2), generator=gen, device=dev)
        k[:, 0] |= 1
        return k

    for nb, bsz, K in MH_SHAPES:
        ids = torch.randint(0, 2**31 - 1, (nb, bsz), generator=gen,
                            device=dev, dtype=torch.int32)
        keys = keys_for(K)
        if not torch.equal(mh.minhash_even_buckets(ids, keys),
                           ref.minhash_even_buckets_ref(ids, keys)):
            raise AssertionError(f"MinHash differs at ({nb},{bsz},{K})")
        print(f"  ({nb},{bsz},{K}): bit-exact")
    sizes = torch.randint(0, 50, (300,), generator=gen, device=dev)
    sizes[::5] = 0                                  # empty segments
    offsets = torch.cat([sizes.new_zeros(1), sizes.cumsum(0)]).int()
    ids = torch.randint(0, N_FIT, (int(offsets[-1]),), generator=gen,
                        device=dev, dtype=torch.int32)
    keys = keys_for(3)
    if not torch.equal(mh.minhash_segments(ids, offsets, keys),
                       ref.minhash_segments_ref(ids, offsets, keys)):
        raise AssertionError("MinHash differs on ragged CSR segments")
    print("  ragged CSR, 300 segments (60 empty): bit-exact")
    cfg = rt.GeekConfig(pair_cap=1 << 21)
    S, bsz = cfg.m * cfg.t, N_FIT // cfg.t          # 2560 x 15625
    ids = torch.randint(0, N_FIT, (S * bsz,), generator=gen, device=dev,
                        dtype=torch.int32)
    offsets = (torch.arange(S + 1, device=dev) * bsz).int()
    keys = keys_for(cfg.silk_k)
    sig_k = mh.minhash_segments(ids, offsets, keys)
    sig_p = ref.minhash_segments_ref(ids, offsets, keys)
    if not torch.equal(sig_k, sig_p):
        raise AssertionError("MinHash differs at the main path's shape")
    mh_err = float((sig_k - sig_p).abs().max())
    mh_ms = cuda_ms(lambda: mh.minhash_segments(ids, offsets, keys), 50)
    mh_plain_ms = cuda_ms(lambda: ref.minhash_segments_ref(ids, offsets,
                                                           keys), 3)
    mh_bytes = ids.numel() * 4 + offsets.numel() * 4 + keys.numel() * 4 + S * 4
    # ~10 integer operations per hash (multiply-add, three xor-shifts, two
    # multiplies) plus a min, K hashes per id; priced at the 32-bit
    # non-tensor rate
    mh_ops = ids.numel() * cfg.silk_k * 11
    mh_bound = max(mh_bytes / PEAK_BYTES, mh_ops / PEAK_F32_FLOPS) * 1e3
    mh_by = "bytes" if mh_bytes / PEAK_BYTES >= mh_ops / PEAK_F32_FLOPS \
        else "operations"
    print(f"  ({S} segments x {bsz} ids, K={cfg.silk_k}): bit-exact; kernel "
          f"{mh_ms:.4f} ms, plain {mh_plain_ms:.3f} ms, bound "
          f"{mh_bound:.4f} ms ({mh_by}: {mh_bytes / 1e6:.1f} MB)")
    del ids, offsets, sig_k, sig_p

    phase("4 main path: GEEK(cfg).fit + predict at 1M x 128")
    print(f"  config {cfg}")
    da.distance_argmin_l2.launches = 0
    mh.minhash_segments.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est = rt.GEEK(cfg)
    model = est.fit(rt.DenseData(x_fit), 0)
    res = est.result_
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_l2, fit_mh = da.distance_argmin_l2.launches, mh.minhash_segments.launches
    t0 = time.perf_counter()
    lab_fit, dist_fit = rt.predict(model, x_fit)
    torch.cuda.synchronize()
    pred_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab_new, dist_new = rt.predict(model, x_new)
    torch.cuda.synchronize()
    pred_new_s = time.perf_counter() - t0
    launches = {"l2": da.distance_argmin_l2.launches,
                "minhash": mh.minhash_segments.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    k_star, overflow = int(res.k_star), int(res.overflow)
    print(f"  fit {fit_s:.3f} s: k*={k_star}, overflow={overflow}, launches "
          f"L2 {fit_l2}, MinHash {fit_mh}")
    print(f"  predict: fit rows {N_FIT / pred_fit_s:,.0f} points/s, fresh "
          f"rows {N_FRESH / pred_new_s:,.0f} points/s; launches after fit "
          f"and predicts {launches}")
    print(f"  purity {purity(res.labels, data.true_labels[:N_FIT], cfg.k_max):.4f}"
          f" (fit), {purity(lab_new, data.true_labels[N_FIT:], cfg.k_max):.4f}"
          f" (fresh); peak device memory {peak_gb:.2f} GiB")
    if k_star <= 0 or overflow != 0:
        raise AssertionError(f"k*={k_star}, overflow={overflow}")
    if not torch.equal(lab_fit, res.labels):
        raise AssertionError("predict on the fit rows differs from the fit")
    if fit_mh < cfg.silk_l or fit_l2 < 1:
        raise AssertionError(f"fit launched L2 {fit_l2}, MinHash {fit_mh}")
    if launches["l2"] < fit_l2 + 2:
        raise AssertionError("predict did not launch the L2 kernel")
    for t in (model.centers, res.dists, dist_new):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite centers or distances")
    if int(lab_new.min()) < 0 or int(lab_new.max()) >= cfg.k_max:
        raise AssertionError("labels out of range")

    # the L2 kernel at the main path's own inputs: the fit rows and the
    # fitted centers (k* of k_max valid: the work the data needs)
    cen, cv = model.centers, model.center_valid
    l2_ms = cuda_ms(lambda: da.distance_argmin_l2(x_fit, cen, cv), 20)
    l2_plain_ms = cuda_ms(lambda: ref.distance_argmin_l2_ref(x_fit, cen, cv), 5)
    l2_lib_ms = cuda_ms(lambda: x_fit @ cen.T, 20)
    kv = int(cv.sum())
    l2_flops = 2.0 * N_FIT * kv * D
    l2_bytes = 4.0 * (N_FIT * D + cen.numel() + 2 * cen.shape[0] + 2 * N_FIT)
    l2_bound = max(l2_flops / PEAK_F32_FLOPS, l2_bytes / PEAK_BYTES) * 1e3
    l2_by = "operations" if l2_flops / PEAK_F32_FLOPS >= l2_bytes / PEAK_BYTES \
        else "bytes"
    print(f"  L2 at ({N_FIT},{cen.shape[0]},{D}), {kv} valid: kernel "
          f"{l2_ms:.3f} ms, plain {l2_plain_ms:.3f} ms, x @ c.T "
          f"{l2_lib_ms:.3f} ms, bound {l2_bound:.3f} ms ({l2_by})")

    phase("5 checkpoints")
    with tempfile.TemporaryDirectory() as tmp:
        rt.save_model(tmp, model)
        back = rt.restore_model(tmp)
        if not torch.equal(rt.predict(back, x_new)[0], lab_new):
            raise AssertionError("save/restore changed the labels")
    print("  port save_model -> restore_model: labels identical")
    ref_model = rt.restore_model(os.path.join(FIXTURE, "ckpt"))
    q = torch.from_numpy(np.load(os.path.join(FIXTURE, "queries.npy"))).to(dev)
    want = torch.from_numpy(np.load(os.path.join(FIXTURE, "labels.npy"))).to(dev)
    before = da.distance_argmin_l2.launches
    got, _ = rt.predict(ref_model, q)
    if da.distance_argmin_l2.launches != before + 1:
        raise AssertionError("fixture predict did not run the kernel")
    rows = (got != want).nonzero().flatten()
    cf = ref_model.centers.double()
    qd = q[rows].double()
    da_ = ((qd - cf[got[rows].long()]) ** 2).sum(1)
    db_ = ((qd - cf[want[rows].long()]) ** 2).sum(1)
    tol = L2_RTOL * ((q[rows].double() ** 2).sum(1) + (cf ** 2).sum(1).max())
    if bool(((da_ - db_).abs() > tol).any()):
        raise AssertionError("reference fixture labels not reproduced")
    print(f"  reference fixture (k_max={ref_model.k_max}, d={ref_model.d}): "
          f"{q.shape[0]} labels reproduced, near-ties {rows.numel()}")

    kernels = [
        {"name": "distance_argmin_l2", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:188",
         "launches": launches["l2"], "max_abs_err": l2_err, "ms": l2_ms,
         "plain_ms": l2_plain_ms, "bound_ms": l2_bound, "bound_by": l2_by,
         "library_ms": l2_lib_ms},
        {"name": "minhash_even_buckets", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/minhash_buckets.cu",
         "replaces": "src/repro/kernels/minhash_buckets.py:58",
         "launches": launches["minhash"], "max_abs_err": mh_err, "ms": mh_ms,
         "plain_ms": mh_plain_ms, "bound_ms": mh_bound, "bound_by": mh_by,
         "library_ms": None},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
