#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, and drives the
three main paths, each with every launch count set to 0 just before it
and read just after:

- dense: ``GEEK(cfg).fit(DenseData(x), seed)`` then ``predict`` at the
  ANN_SIFT1M base set's shape (1,000,000 x 128 float32), L2 kernel;
- heterogeneous: ``fit(HeteroData(x_num, x_cat), seed)`` then predict on
  GeoNames-shaped rows (2,000,000 x (5 numeric + 4 categorical)),
  equality Hamming kernel;
- sparse: ``fit(SparseData(sets, mask), seed)`` then predict on sets
  shaped after the UCI URL Reputation set (2,396,130 sets of 116 items
  from 3,231,961 features), 16-bit packed Hamming kernel;

the SILK bucket MinHash kernel on all three. Then the multi-device paths,
on a one-rank NCCL process group started in this process (a card runs one
rank; more ranks are shown by the gloo tests on the CPU):

- the same three fits through ``fit(..., mesh=make_mesh())`` (distributed
  SILK discovery) and ``make_predict_sharded``, which must equal the
  in-core fits and predicts bit for bit;
- the paper's table-sync fit, ``make_fit_dense`` at 1,000,000 x 128 with
  two Lloyd refine sweeps, with and without ``compress_collectives``:
  each sweep one launch of the L2 assign-and-accumulate kernel.

Then the LM serving path: the two flash kernels against their plain
versions over the reference's sweeps (phase 10), and Qwen3-0.6B at full
width (28 layers, d_model 1,024, bf16, weights drawn from a seed) through
``clustered_decode``, exact and clustered (phase 11): a 2,048-token
prefill on the flash-attention kernel, 224 per-head GEEK fits, 64 decode
steps, one refresh at step 32. The clustered step keeps each layer's kv
heads as one stacked state, attends on the centroid-attention kernel's
decode routine over it in place, and routes and EMA-updates every head's
new key in one launch of the absorb kernel; it is captured once as a
CUDA graph and replayed (its kernels' launches are counted at every
replay), and held to the same run with the step eager and to the same
runs with the absorb swapped for the unfused head-batched route and EMA.

All data is generated from a seed, not downloaded. It checks that each
path launched its kernels, round-trips checkpoints, and reproduces the
labels of models fitted and saved by the JAX reference
(``tests/data/geek_ref_{dense,hetero,sparse}``).
Any failure raises and exits non-zero. The line before the last is a
JSON object with each kernel's launches, error, times and bound; the
last line is ``{"ok": true, "device": {...}}``.

Imports only torch, numpy, the standard library and ``repro_torch``.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
FIXTURE = os.path.join(DATA, "geek_ref_dense")

# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# 32-bit integer add/logic/shift/compare per clock per SM, and __popc
# (CUDA C++ Programming Guide, throughput table, compute capability 9.0);
# times the SM count and the SM clock read from the card. Integer
# multiply-adds (IMAD, IMAD.HI) issue on the FMA pipe, also 64 a clock
# per SM: an add or a shift by a constant can go there as a multiply-add
# by a value the compiler does not see (tools/kernel_variants.py, --kernel
# packed, variants (e*)), so the FMA pipe's time uses the same rate.
INT32_PER_CLK, POPC_PER_CLK = 64, 16
# The least ops a word a packed Hamming function needs, by pipe: (integer
# pipe: logic, compares; FMA pipe: adds and shift-adds; __popc), taken
# over the op mixes shown bit-exact at every width, three-input logic as
# one LOP3. b = 1: xor; the count's add; a popc (the count itself).
# b = 2-16: the SWAR field test's xor, and, or-and ((t | z) & high) on
# the integer pipe; t = (z & low) + low, the count's adds and, for one
# pair of every 4 words, the odd word's flags moved down a bit
# (IMAD.HI) onto the even word's, so 3 popc for 4 words: 3 + 2 + 0.75,
# which puts the popc pipe (0.75 / 16) level with the integer pipe
# (3 / 64) (variant (e1i), bit-exact at every width; more pairs or more
# shifted words only move work between pipes that are not the limit).
# b = 32: a compare and a predicated add. The equality function needs the
# same per column. Both keep a running minimum: a compare and a select
# per (row, center), on the integer pipe.
PACKED_OPS = {1: (1, 1, 1), 2: (3, 2, 0.75), 4: (3, 2, 0.75),
              8: (3, 2, 0.75), 16: (3, 2, 0.75), 32: (1, 1, 0)}
EQUALITY_OPS = (1, 1)


def hamming_op_times(pairs, words, ops, int_rate, popc_rate):
    """Seconds of each pipe for ``pairs`` (row, valid center) pairs of
    ``words`` columns at ``ops`` = (integer, FMA, popc) a column, plus the
    running minimum's compare and select a pair on the integer pipe."""
    ints, fmas, popcs = (*ops, 0)[:3]
    return [pairs * (words * ints + 2) / int_rate,
            pairs * words * fmas / int_rate,
            pairs * words * popcs / popc_rate]

N_FIT, N_FRESH, D, K_TRUE = 1_000_000, 65_536, 128, 64
L2_SHAPES = [(64, 8, 16), (130, 33, 70), (257, 128, 128), (100, 5, 960)]
# validity layouts that the L2 kernels' skipping of wholly dead 64-center
# tiles must keep: name -> (k, valid of arange(k)); each run at n not a
# multiple of the 128 rows a block, rows resident (d <= 256, 16-byte
# aligned or not) and chunked (d = 960)
DEAD_TILE_LAYOUTS = {
    "live prefix": (1024, lambda i: i < 158),
    "leading dead tiles": (300, lambda i: i >= 150),
    "dead tile between live ones": (200, lambda i: (i < 40) | (i >= 140)),
    "all dead": (130, lambda i: torch.zeros_like(i, dtype=torch.bool)),
    "k not a multiple of the tile": (70, lambda i: i % 7 != 3),
}
LAYOUT_SHAPES = [(20_001, 128), (3_001, 70), (1_001, 960)]
# the accumulating kernel's sweep: k not a multiple of the 64-center tile,
# more rows than its 256 slots hold tiles, and the main path's k_max
ACC_SHAPES = L2_SHAPES + [(20_000, 70, 128), (40_000, 1024, 128)]
REFINE_SWEEPS = 2
MH_SHAPES = [(10, 8, 1), (100, 64, 3), (33, 17, 5)]
# the reference's Hamming sweeps (tests/test_kernels.py), then wider ones
HAM_SHAPES = [(50, 4, 9, 5), (129, 17, 45, 20), (64, 8, 400, 1 << 15),
              (20_000, 1024, 9, 12), (5_000, 1024, 64, 1 << 16)]
PACKED_SHAPES = [(50, 4, 9, 4), (129, 17, 45, 8), (64, 8, 400, 16),
                 (33, 70, 7, 2)] + [(3_000, 300, 64, b)
                                    for b in (1, 2, 4, 8, 16, 32)]
# GeoNames-shaped rows (the gazetteer has ~12M; cut for the smoke's time)
N_HET, K_HET = 2_000_000, 32
# the UCI URL Reputation set's rows, features and mean non-zeros
N_URL, U_URL, NNZ_URL, K_URL = 2_396_130, 3_231_961, 116, 32
# d² tolerance, relative to the expansion's scale ‖x‖² + max‖c‖²: about
# 170 float32 ulps, above either side's rounding, far below a real gap
L2_RTOL = 1e-5
# bf16 dense tensor-core peak (NVIDIA data sheet, H100 SXM, 700 W): the
# bound of the attention kernels' products
PEAK_BF16_FLOPS = 989e12
# the reference's flash sweeps (tests/test_kernels.py): (B, Hq, Hkv, S, dh)
# and (B, Hq, Hkv, S, K, dh) with 5 dead centroids; then the main path's
FA_SHAPES = [(1, 4, 4, 128, 32), (2, 8, 2, 100, 64), (1, 6, 1, 65, 64),
             (1, 2, 1, 70, 128)]
CENT_SHAPES = [(1, 4, 4, 1, 48, 32), (2, 4, 2, 3, 100, 64),
               (1, 3, 1, 40, 33, 16), (1, 2, 1, 1, 200, 128)]
# float32: 2e-4 relative and absolute, the reference's own sweep (online
# against two-pass softmax, a few ulps a key over up to 2,048 keys);
# bfloat16: one bf16 ulp (2^-7 relative), since kernel and plain version
# each round a float32 result once
FA_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2.0**-7, 1e-6)}
# the KV-cache serving path: Qwen3-0.6B at full width, one sequence
KV_ARCH, KV_PROMPT, KV_DECODE, KV_KMAX = "qwen3_0_6b", 2048, 64, 64
KV_EMA, KV_REFRESH = 0.1, 32
# the prefill's logits through the flash-attention kernel against the plain
# attention on the card, relative L2 error. Each layer rounds its attention
# output to bf16, and where the two float32 results straddle a rounding
# boundary a one-ulp difference enters the residual stream and grows through
# the 28 random-weight layers: 0.0166-0.0177 measured on an H100, of the
# order of the same forward with the plain attention in float64 (0.0177-
# 0.0183, printed beside it). Two faults planted in the plain attention (no
# causal mask; every query head on the next kv head) run beside it and must
# land above the limit: 1.26-1.34 and 1.39-1.43 measured on an H100.
KV_LOGIT_RTOL = 0.1
KV_FAULTS = ("non-causal", "next kv head")
# layers whose clustered attention is held to the error bound
KV_BOUND_LAYERS = (0, 13, 27)
# decode steps of the profiled runs that measure the device's busy share
KV_BUSY_STEPS = 16
# the decode routine's sweep beside the main path's shape: (B, Hq, Hkv, K,
# dh), as tests/test_torch_cuda.py's
DECODE_SHAPES = [(1, 4, 4, 128, 128), (2, 8, 2, 33, 32), (1, 6, 2, 300, 16)]
# the absorb kernel's sweep: (kv heads, k_max, head dim), as
# tests/test_torch_cuda.py's; the main path's first
ABSORB_SHAPES = [(8, 64, 64), (2, 33, 32), (4, 128, 128)]


def absorb_rtol(d):
    """The absorb kernel's tolerance on radius, v_radius and v_max,
    relative: each is a norm of d float32 squares (plus an add and a max),
    summed in the kernel's order and in torch's, which are not the same;
    two sums of d non-negative terms in any two orders lie within
    2(d - 1)·2⁻²⁴ of each other, relative, the square root halves that,
    and the add rounds once more: (d + 2)·2⁻²⁴."""
    return (d + 2) * 2.0**-24


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


def device_ms(fn, iters, match=""):
    """Device time (ms) per call of ``fn`` spent in kernels whose name
    contains ``match`` (a string, or a tuple of strings any of which may
    match; all kernels for ""), from ``torch.profiler`` over ``iters``
    calls after one warm-up call: no host time in it. The profiler's
    tracing starts late: a trace begun just before a short loop can miss
    most of its launches, or all of them. So the calls are traced in a
    second step of the profiler's schedule, after a warm-up step of
    ``iters`` calls whose trace is dropped; and each kernel's time is its
    mean over the events the trace holds of it, times its launches a
    call (its events over ``iters``, rounded, at least 1)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    names = match if isinstance(match, tuple) else (match,)
    traced = []
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    total = 0.0
    for e in traced:
        if any(m in e.key for m in names) and e.self_device_time_total > 0:
            per_call = max(1, round(e.count / iters))
            total += e.self_device_time_total / e.count * per_call
    if total == 0.0:
        raise AssertionError(f"no kernel named like {match!r} was traced")
    return total / 1e3


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


def acc_check(x, c, valid, what):
    """Hold the accumulating kernel against the L2 kernel (labels and d²
    bit for bit), itself (a second call, bit for bit), its plain version
    (labels but for near-ties), its own summation order rebuilt in plain
    float32 (sums bit for bit, so one dropped or doubled row fails) and
    float64 (counts exact; sums within the float32 summation bound
    (members + slots) · 2⁻²⁴ · Σ|x|). Returns the sums' largest absolute
    deviation from float64."""
    from repro_torch.core import assign
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import ref
    out = da.distance_argmin_l2_accumulate(x, c, valid)
    labels, d2, sums, cnt = out
    l1, d1 = da.distance_argmin_l2(x, c, valid)
    if not (torch.equal(labels, l1) and torch.equal(d2, d1)):
        raise AssertionError(f"{what}: labels or d² differ from the L2 kernel")
    again = da.distance_argmin_l2_accumulate(x, c, valid)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{what}: two calls differ")
    pl, pd, _, _ = assign.assign_l2_with_partials(x.float(), c.float(), valid)
    if bool(valid.any()):
        l2_agreement(x, c, valid, (labels, d2), (pl, pd))
    elif bool(labels.any()) or not torch.equal(pl, labels):
        raise AssertionError(f"{what}: no valid center, yet a label is not 0")
    lab = labels.long()
    if not torch.equal(cnt, torch.bincount(lab, minlength=c.shape[0]).float()):
        raise AssertionError(f"{what}: counts differ")
    slots = min(da.ACC_SLOTS, -(-x.shape[0] // da.BN))
    if not torch.equal(sums, ref.distance_argmin_l2_acc_sums_ref(
            x, labels, c.shape[0], slots, da.BN)):
        raise AssertionError(f"{what}: sums differ from the kernel's order "
                             "rebuilt in float32")
    x64 = x.double()
    want = torch.zeros(sums.shape, dtype=torch.float64, device=x.device)
    want.index_add_(0, lab, x64)
    abs_sum = torch.zeros_like(want).index_add_(0, lab, x64.abs())
    bound = (cnt.double()[:, None] + da.ACC_SLOTS) * 2.0**-24 * abs_sum
    err = (sums.double() - want).abs()
    if bool((err > bound + 1e-30).any()):
        raise AssertionError(f"{what}: sums off by up to {float(err.max())}")
    return float(err.max())


def sharded_check(name, est, data, model, res, fresh, mesh, kernels,
                  path_kernel):
    """Drive one data kind's sharded path (fit with mesh=, then
    make_predict_sharded) with every count reset just before and read just
    after, and hold it to the in-core fit and predict bit for bit.
    Returns (launches, fit s)."""
    import repro_torch as rt
    reset_launches(*kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_s = est.fit(data, 0, mesh=mesh)
    r_s = est.result_
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    lab_s, dist_s = rt.make_predict_sharded(mesh)(m_s, *fresh.parts)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    lab_p, dist_p = est.predict(fresh, model=model)
    same = (torch.equal(r_s.labels, res.labels)
            and torch.equal(r_s.dists, res.dists)
            and torch.equal(m_s.centers, model.centers)
            and torch.equal(m_s.center_valid, model.center_valid)
            and torch.equal(m_s.radius, model.radius)
            and int(r_s.k_star) == int(res.k_star)
            and int(r_s.overflow) == int(res.overflow))
    if not same:
        raise AssertionError(f"{name}: the sharded fit differs from the "
                             "in-core fit")
    if not (torch.equal(lab_s, lab_p) and torch.equal(dist_s, dist_p)):
        raise AssertionError(f"{name}: make_predict_sharded differs from "
                             "predict")
    if launches["minhash_segments"] < est.cfg.silk_l or \
            launches[path_kernel.__name__] < 2:
        raise AssertionError(f"{name}: sharded path launched {launches}")
    print(f"  sharded {name} fit {fit_s:.3f} s at g=1: labels, dists, "
          f"centers, radius, k*={int(r_s.k_star)}, overflow equal the in-core "
          f"fit; make_predict_sharded equals predict; launches {launches}")
    return launches, fit_s


def purity(labels, truth, k_max, k_true=K_TRUE):
    joint = torch.bincount(labels.long() * k_true + truth.long(),
                           minlength=k_max * k_true).view(k_max, k_true)
    return float(joint.max(1).values.sum()) / labels.numel()


def smi(query):
    """One ``nvidia-smi --query-gpu`` field list for card 0, as
    ``--format=csv,noheader`` prints it."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound(nbytes, op_times):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the longest of the operation times (seconds)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, max(op_times)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def reset_launches(*kernels):
    for k in kernels:
        k.launches = 0


def busy_per_range(prof, span, skip=0, names=()):
    """(device busy ms, device events, wall ms, named) per host range named
    ``span`` in a ``torch.profiler`` trace, the first ``skip`` ranges left
    out: the union of the device intervals (kernels, copies, fills) that
    start inside a range, the range's wall time under the profiler, and
    for each of ``names`` the list, range by range, of the device events
    whose name contains it. The range's own annotation on the device's
    timeline is not device work."""
    import bisect
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == span and "CUDA" not in str(e.device_type))
    spans = spans[skip:]
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events
                 if "CUDA" in str(e.device_type) and e.name != span)
    starts = [k0 for k0, _, _ in dev]
    busy, seen = 0.0, 0
    named = {name: [] for name in names}
    for s0, s1 in spans:
        reach = s0
        inside = dev[bisect.bisect_left(starts, s0):
                     bisect.bisect_left(starts, s1)]
        for k0, k1, _ in inside:
            busy += max(0.0, k1 - max(k0, reach))
            reach = max(reach, k1)
            seen += 1
        for name, counts in named.items():
            counts.append(sum(name in e for _, _, e in inside))
    n = max(len(spans), 1)
    return (busy / n / 1e3, seen / n,
            sum(s1 - s0 for s0, s1 in spans) / n / 1e3, named)


def ham_exact(kernel_out, plain_out, what):
    """Raise unless labels and counts are equal; return max |Δcount| (0)."""
    (lk, ck), (lp, cp) = kernel_out, plain_out
    cp = cp.to(torch.int32)
    if not (torch.equal(lk, lp) and torch.equal(ck, cp)):
        bad = ((lk != lp) | (ck != cp)).nonzero().flatten()
        raise AssertionError(f"{what}: kernel differs from plain at rows "
                             f"{bad[:10].tolist()}")
    return float((ck - cp).abs().max()) if ck.numel() else 0.0


def code_path(kernels, name, est, fit_data, fresh_data, truth_fit,
              truth_fresh, k_true, path_kernel):
    """Drive one code-space main path with every count reset just before
    and read just after; check it. Returns (model, launches, fit s)."""
    reset_launches(*kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = est.fit(fit_data, 0)
    res = est.result_
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launch = {k.__name__: k.launches for k in kernels}
    t0 = time.perf_counter()
    lab_fit, _ = est.predict(fit_data)
    torch.cuda.synchronize()
    pred_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab_new, dist_new = est.predict(fresh_data)
    torch.cuda.synchronize()
    pred_new_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    k_star, overflow = int(res.k_star), int(res.overflow)
    n_fit, n_new = lab_fit.numel(), lab_new.numel()
    k_max = model.k_max
    pur_fit = purity(res.labels, truth_fit, k_max, k_true)
    pur_new = purity(lab_new, truth_fresh, k_max, k_true)
    print(f"  fit {fit_s:.3f} s: k*={k_star}, overflow={overflow}, impl "
          f"{model.impl} ({model.code_bits} bits), launches {fit_launch}")
    print(f"  predict (encode + assign): fit rows {n_fit / pred_fit_s:,.0f} "
          f"points/s, fresh rows {n_new / pred_new_s:,.0f} points/s; "
          f"launches after fit and predicts {launches}")
    print(f"  purity {pur_fit:.4f} (fit), {pur_new:.4f} (fresh); peak device "
          f"memory {peak_gb:.2f} GiB")
    if k_star <= 0 or overflow != 0:
        raise AssertionError(f"{name}: k*={k_star}, overflow={overflow}")
    if not torch.equal(lab_fit, res.labels):
        raise AssertionError(f"{name}: predict on the fit rows differs from "
                             "the fit")
    mh = fit_launch["minhash_segments"]
    if mh < est.cfg.silk_l or fit_launch[path_kernel.__name__] < 1:
        raise AssertionError(f"{name}: fit launched {fit_launch}")
    if launches[path_kernel.__name__] < fit_launch[path_kernel.__name__] + 2:
        raise AssertionError(f"{name}: predict did not launch "
                             f"{path_kernel.__name__}")
    if not bool(torch.isfinite(dist_new).all()) or \
            int(lab_new.min()) < 0 or int(lab_new.max()) >= k_max:
        raise AssertionError(f"{name}: bad fresh-row labels or distances")
    return model, launches, fit_s


def fa_check(got, want, what):
    """Raise unless the kernel's output is finite and within FA_TOL of the
    plain version's; return max |Δ|."""
    rtol, atol = FA_TOL[got.dtype]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{what}: off by up to {float(err.max()):.3g}")
    return float(err.max())


def flash_phase(dev, gen):
    """Phase 10: both flash kernels against their plain versions over the
    reference's sweeps, all-dead centroids and the main path's shapes,
    then timed at the main path's shapes and layouts. Returns their rows
    of the kernels line (launches filled in by phase 11)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    phase("10 flash kernels vs plain")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    fa_err = cent_err = 0.0
    took = {}
    for B, Hq, Hkv, S, dh in FA_SHAPES + [(1, 16, 8, KV_PROMPT, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            before = dict(fa.flash_attention.by_routine)
            q, k, v = (randn(B, h, S, dh, dtype=dtype) for h in (Hq, Hkv, Hkv))
            for causal in (True, False):
                fa_err = max(fa_err, fa_check(
                    fa.flash_attention(q, k, v, causal=causal),
                    ref.attention_ref(q, k, v, causal=causal),
                    f"flash_attention {(B, Hq, Hkv, S, dh)} {dtype} "
                    f"causal={causal}"))
            took[dtype] = [r for r, n in fa.flash_attention.by_routine.items()
                           if n > before[r]]
            if took[dtype] != [fa.ROUTINES[dtype]]:
                raise AssertionError(f"flash_attention {dtype} took "
                                     f"{took[dtype]}")
        print(f"  flash_attention ({B},{Hq},{Hkv},{S},{dh}): float32 and "
              "bfloat16, causal and not, within tolerance")
    print(f"  routines taken: float32 -> {took[torch.float32][0]}; bfloat16 "
          f"-> {took[torch.bfloat16][0]}")
    for B, Hq, Hkv, S, K, dh in CENT_SHAPES + [(1, 16, 8, 1, KV_KMAX + 1, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(B, Hq, S, dh, dtype=dtype)
            c, vc = randn(B, Hkv, K, dh), randn(B, Hkv, K, dh)
            lm = torch.log1p(8.0 * torch.rand((B, Hkv, K), generator=gen,
                                              device=dev))
            for dead in (5, K):
                lm[..., K - dead:] = -1e30
                got = fa.flash_centroid_attention(q, c, vc, lm)
                what = f"centroid {(B, Hq, Hkv, S, K, dh)} {dtype} dead={dead}"
                cent_err = max(cent_err, fa_check(
                    got, ref.centroid_attention_ref(q, c, vc, lm), what))
            mean = vc.mean(2, keepdim=True).repeat_interleave(Hq // Hkv, 1)
            fa_check(got, mean.expand(got.shape).to(dtype), what + " (mean)")
        print(f"  flash_centroid_attention ({B},{Hq},{Hkv},{S},{K},{dh}): "
              "float32 and bfloat16 queries, 5 dead and all dead (= the "
              "mean of the values), within tolerance")

    # flash_attention at the prefill's inputs: Qwen3-0.6B's layer layout
    # (B, S, H, dh) in bf16, seen transposed as the port passes it
    B, Hq, Hkv, S, dh = 1, 16, 8, KV_PROMPT, 64
    q = randn(B, S, Hq, dh, dtype=torch.bfloat16).transpose(1, 2)
    k, v = (randn(B, S, Hkv, dh, dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    fa_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
    fa_plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), 5)
    fa_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    # each input read once and the output written once (bf16), against
    # 4·dh flops per (query, key) pair of the causal half at the bf16 rate
    fa_bound, fa_by = bound(2.0 * dh * S * (2 * Hq + 2 * Hkv) * B,
                            [4.0 * B * Hq * dh * S * (S + 1) / 2
                             / PEAK_BF16_FLOPS])
    fa_dev = device_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20,
                       "flash_attention_bf16_kernel")
    sdpa_dev = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20, "sdpa")
    print(f"  flash_attention at ({B},{Hq},{Hkv},{S},{dh}) bf16 causal: "
          f"kernel {fa_ms:.4f} ms, plain {fa_plain_ms:.4f} ms, SDPA "
          f"{fa_lib_ms:.4f} ms (kernel / SDPA {fa_ms / fa_lib_ms:.2f}), bound "
          f"{fa_bound:.4f} ms ({fa_by}); device time alone (torch.profiler): "
          f"kernel {fa_dev:.4f} ms, SDPA's kernel {sdpa_dev:.4f} ms (kernel / "
          f"SDPA {fa_dev / sdpa_dev:.2f})")

    # flash_centroid_attention at a decode step's inputs: bf16 queries (a
    # transposed view), float32 centroids of k_max rows plus the step's own
    # row, log-mass
    K = KV_KMAX + 1
    q = randn(B, 1, Hq, dh, dtype=torch.bfloat16).transpose(1, 2)
    c, vc = randn(B, Hkv, K, dh), randn(B, Hkv, K, dh)
    lm = torch.log1p(8.0 * torch.rand((B, Hkv, K), generator=gen, device=dev))
    lm[..., KV_KMAX // 2:KV_KMAX] = -1e30
    cent_ms = cuda_ms(lambda: fa.flash_centroid_attention(q, c, vc, lm), 200)
    cent_plain_ms = cuda_ms(lambda: ref.centroid_attention_ref(q, c, vc, lm),
                            50)
    qf = q.float()
    mask = lm.repeat_interleave(Hq // Hkv, 1)[:, :, None, :]
    cent_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qf, c, vc, attn_mask=mask, enable_gqa=True), 200)
    cent_bound, cent_by = bound(
        2.0 * B * Hq * dh * 2 + 4.0 * B * Hkv * K * (2 * dh + 1),
        [4.0 * B * Hq * K * dh / PEAK_BF16_FLOPS])
    print(f"  flash_centroid_attention at ({B},{Hq},{Hkv},1,{K},{dh}): "
          f"kernel {cent_ms:.4f} ms, plain {cent_plain_ms:.4f} ms, SDPA with "
          f"a float mask {cent_lib_ms:.4f} ms, bound {cent_bound:.6f} ms "
          f"({cent_by})")
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:92",
         "launches": None, "max_abs_err": fa_err, "ms": fa_ms,
         "plain_ms": fa_plain_ms, "bound_ms": fa_bound, "bound_by": fa_by,
         "library_ms": fa_lib_ms},
        {"name": "flash_centroid_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:173",
         "launches": None, "max_abs_err": cent_err, "ms": cent_ms,
         "plain_ms": cent_plain_ms, "bound_ms": cent_bound,
         "bound_by": cent_by, "library_ms": cent_lib_ms},
    ]


def absorb_inputs(gen, dev, H, K, d, dtype, live=None):
    """One layer's state and one step's fresh rows for the absorb kernel:
    (keys, values, state). keys and values (H, 1, d) in ``dtype``, strided
    views of one projection (the step's layout); state the
    ``LayerKVCluster`` tensors by name. ``live`` (H,) gives the valid rows
    of each head as a prefix (a fitted layout); without it 80 % are valid
    at random, and: head 0 ties two valid centers (the first must win),
    the last head has no valid center, head 1 of more than two hits its
    last row, and a dead row equal to its head's key is skipped."""
    f32 = dict(generator=gen, device=dev)
    c, vc = (torch.randn((H, K, d), **f32) for _ in range(2))
    if live is None:
        valid = torch.rand((H, K), **f32) < 0.8
    else:
        valid = torch.arange(K, device=dev)[None, :] < torch.tensor(
            live, device=dev)[:, None]
    kv_rows = torch.randn((1, 1, 2 * H, d), **f32).to(dtype)
    keys = kv_rows[0, :, :H].transpose(0, 1)
    values = kv_rows[0, :, H:].transpose(0, 1)
    if live is None:
        if K > 5:
            c[0, 5] = c[0, 2]
            valid[0, [2, 5]] = True
            keys[0, 0] = c[0, 2] + 0.01 * torch.randn((d,), **f32)
        if H > 2:
            valid[1, K - 1] = True
            keys[1, 0] = c[1, K - 1] + 0.01 * torch.randn((d,), **f32)
        if K > 7:
            valid[:, 7] = False
            c[:, 7] = keys[:, 0].float()
        valid[H - 1] = False
    mass = torch.where(valid, torch.randint(1, 600, (H, K), **f32).float(),
                       0.0)
    state = {"centers": c, "v_cent": vc,
             "radius": torch.rand((H, K), **f32) * 3,
             "v_radius": torch.rand((H, K), **f32) * 3, "mass": mass,
             "center_valid": valid, "v_max": torch.rand((H,), **f32) * 4}
    return keys, values, state


ABSORB_STATE = ("centers", "v_cent", "radius", "v_radius", "mass",
                "center_valid", "v_max")


def absorb_check(keys, values, state, what):
    """Hold one absorb launch on a copy of ``state`` against the
    head-batched route (labels and d² bit for bit) and against the unfused
    path (``kv_cluster.absorb_plain``: the route kernel, then the plain
    EMA) on another copy: labels, centers, v_cent and mass bit for bit,
    radius, v_radius and v_max within ``absorb_rtol``. Returns the largest
    absolute deviation of those three."""
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.serve import kv_cluster as kv
    fused = {n: t.clone() for n, t in state.items()}
    plain = {n: t.clone() for n, t in state.items()}
    c = state["centers"]
    csq = torch.sum(c * c, dim=-1)
    decay = torch.pow(1.0 - KV_EMA, torch.ones((1,), device=c.device))
    lab, d2 = da.l2_absorb_heads(keys, values,
                                 *(fused[n] for n in ABSORB_STATE), csq, decay)
    hl, hd = da.distance_argmin_l2_heads(keys.float(), c, csq,
                                         state["center_valid"])
    if not (torch.equal(lab, hl) and torch.equal(d2, hd)):
        raise AssertionError(f"{what}: absorb labels or d² differ from the "
                             "head-batched route")
    pl, _ = kv.absorb_plain(keys, values, *(plain[n] for n in ABSORB_STATE),
                            csq, ema=KV_EMA)
    if not torch.equal(pl, lab):
        raise AssertionError(f"{what}: absorb labels differ from the plain "
                             "path's")
    for n in ("centers", "v_cent", "mass", "center_valid"):
        if not torch.equal(fused[n], plain[n]):
            raise AssertionError(f"{what}: absorb {n} differs from the "
                                 "plain EMA's bits")
    worst = 0.0
    for n in ("radius", "v_radius", "v_max"):
        rel = float(((fused[n] - plain[n]).abs()
                     / plain[n].abs().clamp(min=1e-30)).max())
        if not rel <= absorb_rtol(c.shape[2]):
            raise AssertionError(f"{what}: absorb {n} off by {rel:.3g} "
                                 "relative")
        worst = max(worst, float((fused[n] - plain[n]).abs().max()))
    return worst


def decode_kernels(dev, cfg, k_stars):
    """Phase 11's kernels of the clustered step at the main path's shapes:
    the absorb kernel (one layer's kv heads, one new key and value each,
    against k_max centroids, the first ``len(k_stars)`` of them valid per
    head, as the run's first layer fitted), the head-batched L2 route that
    its labels are held to (the unfused path's, and the n > 1 path's), and
    the decode routine of the centroid attention (bf16 queries and fresh
    rows over the float32 state): each held to its plain version, then
    timed beside the unfused path, the per-head launches, ``torch.bmm``,
    SDPA and an empty kernel. Returns their rows of the kernels line
    (launches filled in by the caller)."""
    import torch.nn.functional as F

    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.serve import kv_cluster as kv
    gen = torch.Generator(device=dev).manual_seed(2)
    H, hd, Hq = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
    K = KV_KMAX
    ks = torch.tensor(k_stars, device=dev)
    valid = torch.arange(K, device=dev)[None, :] < ks[:, None]
    x = torch.randn((H, 1, hd), generator=gen, device=dev)
    c = torch.randn((H, K, hd), generator=gen, device=dev)
    csq = torch.sum(c * c, dim=-1)
    got = da.distance_argmin_l2_heads(x, c, csq, valid)
    heads_err = 0.0
    for h in range(H):
        one = da.distance_argmin_l2(x[h], c[h], valid[h])
        if not (torch.equal(got[0][h], one[0]) and
                torch.equal(got[1][h], one[1])):
            raise AssertionError(f"head-batched route differs from one "
                                 f"launch on head {h}")
        _, err = l2_agreement(x[h], c[h], valid[h], one,
                              ref.distance_argmin_l2_ref(x[h], c[h],
                                                         valid[h]))
        heads_err = max(heads_err, err)
    heads_ms = cuda_ms(lambda: da.distance_argmin_l2_heads(x, c, csq, valid),
                       500)
    per_head_ms = cuda_ms(lambda: [da.distance_argmin_l2(x[h], c[h], valid[h])
                                   for h in range(H)], 100)
    heads_dev = device_ms(lambda: da.distance_argmin_l2_heads(
        x, c, csq, valid), 50, "l2_argmin")
    per_head_dev = device_ms(lambda: [da.distance_argmin_l2(
        x[h], c[h], valid[h]) for h in range(H)], 50, "l2_argmin")
    heads_plain_ms = cuda_ms(lambda: ref.distance_argmin_l2_heads_ref(
        x, c, csq, valid), 50)
    heads_lib_ms = cuda_ms(lambda: torch.bmm(x, c.transpose(1, 2)), 500)
    bmm_dev = device_ms(lambda: torch.bmm(x, c.transpose(1, 2)), 50)
    # the device time of an empty kernel (a spin of 0 cycles): the least a
    # launch takes on the device, beside the decode-shaped rows
    empty_dev = device_ms(lambda: torch.cuda._sleep(0), 200)
    live = int(ks.sum())
    # the bytes the function needs: x, the valid centers' rows and their
    # ||c||^2 read once (float32), a validity flag a center (a byte),
    # labels and d² written; 2·d flops per (row, valid center) at the
    # float32 rate
    heads_bound, heads_by = bound(
        4.0 * (H * hd + live * hd + live + 2 * H) + H * K,
        [2.0 * live * hd / PEAK_F32_FLOPS])
    print(f"  distance_argmin_l2_heads at ({H}, 1, {K}, {hd}), {live} valid "
          f"centers: bit-identical to {H} launches, one a head; vs plain "
          f"max |Δd²| {heads_err:.3g}; one launch {heads_ms:.4f} ms against "
          f"{H} launches {per_head_ms:.4f} ms (device time alone "
          f"{heads_dev:.4f} / {per_head_dev:.4f} ms), plain "
          f"{heads_plain_ms:.4f} ms, torch.bmm {heads_lib_ms:.4f} ms (device "
          f"{bmm_dev:.4f} ms), bound {heads_bound:.7f} ms ({heads_by}); an "
          f"empty kernel's device time {empty_dev:.4f} ms")

    abs_err = 0.0
    for Hs, Ks, ds in ABSORB_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            abs_err = max(abs_err, absorb_check(
                *absorb_inputs(gen, dev, Hs, Ks, ds, dtype),
                f"absorb ({Hs}, {Ks}, {ds}) {dtype}"))
    # the main path's inputs: bf16 fresh rows, k* valid rows a head
    keys, values, state = absorb_inputs(gen, dev, H, K, hd, torch.bfloat16,
                                        live=k_stars)
    abs_err = max(abs_err, absorb_check(keys, values, state,
                                        "absorb, main path"))
    st = [state[n] for n in ABSORB_STATE]
    decay = torch.pow(1.0 - KV_EMA, torch.ones((1,), device=dev))

    def fused():
        cs = torch.sum(st[0] * st[0], dim=-1)
        return da.l2_absorb_heads(keys, values, *st, cs, decay)

    def unfused():
        cs = torch.sum(st[0] * st[0], dim=-1)
        return kv.absorb_plain(keys, values, *st, cs, ema=KV_EMA)

    abs_ms = cuda_ms(fused, 500)
    abs_dev = device_ms(fused, 50, "l2_absorb_heads_kernel")
    abs_plain_ms = cuda_ms(unfused, 100)
    abs_plain_dev = device_ms(unfused, 50)
    csq_dev = device_ms(lambda: torch.sum(st[0] * st[0], dim=-1), 50)
    # the bytes the function needs: the fresh rows at their element size,
    # the valid centers' rows and their ||c||^2 (float32), a flag a center
    # (a byte), the hit rows of centers and v_cent read and written, the
    # hit entries of radius, v_radius and mass and v_max read and written,
    # the factor, labels and d² written; 2·d flops per (head, valid center)
    # for the route and ~20·d for the EMA, at the float32 rate
    abs_bound, abs_by = bound(
        2 * keys.element_size() * H * hd + 4.0 * (live * hd + live)
        + H * K + 4.0 * (4 * H * hd + 6 * H + 2 * H + 1 + 2 * H),
        [(2.0 * live * hd + 20.0 * H * hd) / PEAK_F32_FLOPS])
    print(f"  l2_absorb_heads over {ABSORB_SHAPES} (heads, k_max, d), float32"
          f" and bfloat16 (a tie, a head with no valid center, a hit on the "
          f"last row, a dead row at the key) and at ({H}, 1, {K}, {hd}) bf16 "
          f"with {live} valid: labels and d² equal the head-batched route's,"
          f" centers, v_cent and mass the unfused path's bit for bit; radii "
          f"and v_max within (d + 2)·2⁻²⁴ relative, max |Δ| {abs_err:.3g}. One "
          f"launch {abs_ms:.4f} ms (device time {abs_dev:.4f} ms), unfused "
          f"route + EMA {abs_plain_ms:.4f} ms (device time of its kernels "
          f"{abs_plain_dev:.4f} ms), both with ‖c‖² ({csq_dev:.4f} ms of "
          f"device time); bound {abs_bound:.7f} ms ({abs_by}); an empty "
          f"kernel's device time {empty_dev:.4f} ms")

    dec_err = 0.0
    for B, hq, hkv, k, dh in DECODE_SHAPES + [(1, Hq, H, K, hd)]:
        for dtype in (torch.float32, torch.bfloat16):
            for case in ("dead", "all dead", "no fresh row"):
                cs, vs = (torch.randn((hkv, k, dh), generator=gen, device=dev)
                          for _ in range(2))
                mass = torch.randint(0, 4, (hkv, k), generator=gen,
                                     device=dev).float()
                ok = torch.rand((hkv, k), generator=gen, device=dev) < 0.8
                if case == "all dead":
                    ok[:] = False
                qkv = torch.randn((B, 1, hq + 2 * hkv, dh), generator=gen,
                                  device=dev).to(dtype)
                q, ek, ev = (qkv[:, :, :hq], qkv[:, :, hq:hq + hkv],
                             qkv[:, :, hq + hkv:])
                ex = {} if case == "no fresh row" else {"extra_k": ek,
                                                         "extra_v": ev}
                dec_err = max(dec_err, fa_check(
                    fa.flash_centroid_decode(q, cs, vs, mass, ok, **ex),
                    ref.centroid_decode_ref(q, cs, vs, mass, ok, **ex),
                    f"decode {(B, hq, hkv, k, dh)} {dtype} {case}"))
    print(f"  flash_centroid_decode over {DECODE_SHAPES + [(1, Hq, H, K, hd)]}"
          f" (B, Hq, Hkv, K, dh), float32 and bfloat16, some dead, all dead, "
          f"no fresh row: within tolerance, max |Δ| {dec_err:.3g}")
    # the main path's inputs: bf16 queries and fresh rows (strided views of
    # one projection), the state in place, k* live rows per head
    qkv = torch.randn((1, 1, Hq + 2 * H, hd), generator=gen,
                      device=dev).to(torch.bfloat16)
    q, ek, ev = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + H], qkv[:, :, Hq + H:]
    vc = torch.randn((H, K, hd), generator=gen, device=dev)
    mass = torch.where(valid, torch.randint(1, 600, (H, K), generator=gen,
                                            device=dev).float(), 0.0)
    got = fa.flash_centroid_decode(q, c, vc, mass, valid, extra_k=ek,
                                   extra_v=ev)
    dec_err = max(dec_err, fa_check(got, ref.centroid_decode_ref(
        q, c, vc, mass, valid, extra_k=ek, extra_v=ev), "decode, main path"))
    dec_ms = cuda_ms(lambda: fa.flash_centroid_decode(
        q, c, vc, mass, valid, extra_k=ek, extra_v=ev), 500)
    dec_dev = device_ms(lambda: fa.flash_centroid_decode(
        q, c, vc, mass, valid, extra_k=ek, extra_v=ev), 50,
        "flash_centroid_decode")
    dec_plain_ms = cuda_ms(lambda: ref.centroid_decode_ref(
        q, c, vc, mass, valid, extra_k=ek, extra_v=ev), 100)
    # SDPA on the same rows, appended and masked beforehand (a yardstick)
    lm = torch.where(valid & (mass > 0), torch.log(mass.clamp(min=1e-9)),
                     -1e30)
    cc = torch.cat([c, ek[0, 0][:, None].float()], 1)[None]
    vv = torch.cat([vc, ev[0, 0][:, None].float()], 1)[None]
    mask = torch.cat([lm, torch.zeros((H, 1), device=dev)], 1)
    mask = mask.repeat_interleave(Hq // H, 0)[None, :, None, :]
    qf = q.transpose(1, 2).float()
    dec_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qf, cc, vv, attn_mask=mask, enable_gqa=True), 500)
    sdpa_dev = device_ms(lambda: F.scaled_dot_product_attention(
        qf, cc, vv, attn_mask=mask, enable_gqa=True), 50)
    # the bytes the function needs: the live centroids' keys and values
    # and their mass (float32), a validity flag a centroid (a byte), the
    # fresh rows' keys and values and the queries at their element size,
    # the output written; 4·dh flops per (query head, row) at the float32
    # rate, the live rows and the fresh ones
    rows_live = live + H
    dec_bound, dec_by = bound(
        4.0 * (2 * live * hd + live) + H * K
        + ek.element_size() * 2 * H * hd + 2 * q.element_size() * Hq * hd,
        [4.0 * (Hq // H) * rows_live * hd / PEAK_F32_FLOPS])
    print(f"  flash_centroid_decode at (1, {Hq}, {H}, {K} + 1, {hd}), bf16 "
          f"queries, {live} live rows: kernel {dec_ms:.4f} ms (device time "
          f"alone {dec_dev:.4f} ms), plain {dec_plain_ms:.4f} ms, SDPA with "
          f"a float mask {dec_lib_ms:.4f} ms (device {sdpa_dev:.4f} ms), bound "
          f"{dec_bound:.7f} ms ({dec_by})")
    return [
        {"name": "l2_absorb_heads", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:188",
         "launches": None, "max_abs_err": abs_err, "ms": abs_ms,
         "plain_ms": abs_plain_ms, "bound_ms": abs_bound,
         "bound_by": abs_by, "library_ms": None},
        {"name": "distance_argmin_l2_heads", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:188",
         "launches": None, "max_abs_err": heads_err, "ms": heads_ms,
         "plain_ms": heads_plain_ms, "bound_ms": heads_bound,
         "bound_by": heads_by, "library_ms": heads_lib_ms},
        {"name": "flash_centroid_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:173",
         "launches": None, "max_abs_err": dec_err, "ms": dec_ms,
         "plain_ms": dec_plain_ms, "bound_ms": dec_bound,
         "bound_by": dec_by, "library_ms": dec_lib_ms},
    ]


def plain_prefill_override(cfg, dtype=torch.float32, fault=None):
    """An attention override computing the reference's cache branch
    (``layers.cache_attention_ref``: the plain softmax over the whole
    cache, no kernel) in ``dtype``, or with one of ``KV_FAULTS`` planted:
    every key visible to every query, or each query head reading the next
    kv head's keys and values."""
    from repro_torch.models import layers as L

    def override(layer, p, h, *, positions, cache, cache_len):
        q, k, v = L.attn_qkv(p, h, cfg, positions=positions)
        L.cache_write(cache, k, v, cache_len)
        kc, vc, seen = cache["k"], cache["v"], positions
        if fault == "non-causal":
            seen = torch.full_like(positions, kc.shape[1] - 1)
        elif fault == "next kv head":
            kc, vc = kc.roll(-1, dims=2), vc.roll(-1, dims=2)
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        o = L.cache_attention_ref(q.to(dtype), kc.to(dtype), vc.to(dtype),
                                  positions=seen)
        B, S = h.shape[:2]
        return o.reshape(B, S, -1).to(h.dtype) @ p["wo"], cache
    return override


def unfused_absorb(keys, values, *state, ema, decay):
    """``ops.l2_absorb_heads`` unfused: the head-batched route kernel,
    then the plain EMA (``kv_cluster.absorb_plain``), on the card."""
    from repro_torch.serve import kv_cluster as kv
    del decay
    return kv.absorb_plain(keys, values, *state, ema=ema)


def fit_kernels(dev, keys, int_rate):
    """Rows 1 and 5 at the LM cell's fit inputs: one per-head GEEK fit
    (k_max KV_KMAX) on a layer's prefill keys of one kv head, the first
    inputs the fit hands to ``ops.distance_argmin_l2`` and
    ``ops.minhash_segments`` recorded, then each kernel timed on them
    (back to back, and device time alone) beside its bound."""
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import minhash_buckets as mh
    from repro_torch.serve import kv_cluster as kv
    seen, real = {}, {}
    for name in ("distance_argmin_l2", "minhash_segments"):
        real[name] = getattr(kv.kops, name)

        def spy(*args, name=name, **kwargs):
            seen.setdefault(name, args)
            return real[name](*args, **kwargs)
        setattr(kv.kops, name, spy)
    try:
        layer = kv.LayerKVCluster(1, keys.shape[1],
                                  kv.default_kv_config(KV_KMAX), ema=KV_EMA,
                                  device=dev)
        layer.start(keys[:, None], keys[:, None])
    finally:
        for name, fn in real.items():
            setattr(kv.kops, name, fn)
    x, c, cv = seen["distance_argmin_l2"]
    n, d = x.shape
    kvalid = int(cv.sum())
    l2_ms = cuda_ms(lambda: da.distance_argmin_l2(x, c, cv), 200)
    l2_dev = device_ms(lambda: da.distance_argmin_l2(x, c, cv), 50,
                       "l2_argmin")
    l2_b, l2_by = bound(4.0 * (n * d + kvalid * d + kvalid + 2 * n)
                        + c.shape[0], [2.0 * n * kvalid * d / PEAK_F32_FLOPS])
    ids, offsets, mkeys = seen["minhash_segments"]
    segs = offsets.numel() - 1
    mh_ms = cuda_ms(lambda: mh.minhash_segments(ids, offsets, mkeys), 200)
    mh_dev = device_ms(lambda: mh.minhash_segments(ids, offsets, mkeys), 50,
                       "minhash")
    mh_b, mh_by = bound(4.0 * (ids.numel() + offsets.numel() + mkeys.numel()
                               + segs),
                        [ids.numel() * mkeys.shape[0] * 10 / int_rate])
    print(f"  at the LM cell's fit inputs (one kv head's {n} prefill keys, "
          f"d {d}): distance_argmin_l2 on ({n}, {c.shape[0]}, {d}), {kvalid} "
          f"valid: {l2_ms:.4f} ms back to back, device time {l2_dev:.4f} ms,"
          f" bound {l2_b:.7f} ms ({l2_by}); minhash_segments on {segs} "
          f"segments, {ids.numel()} ids, {mkeys.shape[0]} hashes: "
          f"{mh_ms:.4f} ms, device time {mh_dev:.4f} ms, bound {mh_b:.7f} ms "
          f"({mh_by})")


def kv_path(rt, dev, gen, all_kernels, int_rate):
    """Phase 11: Qwen3-0.6B at full width through ``clustered_decode``,
    exact and clustered, with every launch count reset just before each
    run and read just after; the prefill's logits against the plain
    attention; the clustered run replayed from its CUDA graph against the
    same run eager, and both against the same runs with the absorb kernel
    swapped for the unfused route + EMA; the device's busy share of the
    decode steps and the step's kernels in its trace; the clustered step's
    kernels (``decode_kernels``); rows 1 and 5 at the fits' inputs; the
    error bound at one decode step of a few layers through the per-head
    API. Returns the launches of the phase-10 kernels (the prefill's, and
    the per-head path's (B, S) kernel) and the rows of the step's
    kernels."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_cluster as kv
    from repro_torch.kernels import distance_argmin as da
    kernels = all_kernels + (fa.flash_attention, fa.flash_centroid_attention,
                             fa.flash_centroid_decode,
                             da.distance_argmin_l2_heads, da.l2_absorb_heads)
    cfg = rt.get_arch(KV_ARCH)
    phase(f"11 KV-cache serving path: {cfg.name} ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}), prompt {KV_PROMPT}, {KV_DECODE} decoded")
    t0 = time.perf_counter()
    params = rt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    print(f"  {M.count_params(cfg):,} parameters ({cfg.dtype}) drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    total = KV_PROMPT + KV_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (1, total), generator=gen,
                           device=dev)
    prompt = tokens[:, :KV_PROMPT]

    # the prefill's logits through flash_attention against the plain attention
    before = fa.flash_attention.launches
    logits_k, _ = M.prefill_step(params, cfg, prompt)
    if fa.flash_attention.launches != before + cfg.num_layers:
        raise AssertionError("the prefill did not run flash_attention once a "
                             "layer")
    plain = {}
    for run in (torch.float32, torch.float64) + KV_FAULTS:
        caches = T.stack_cache_init(cfg, 1, KV_PROMPT, dev)
        over = plain_prefill_override(cfg, run) if isinstance(
            run, torch.dtype) else plain_prefill_override(cfg, fault=run)
        x, _, _ = M.forward(params, cfg, prompt, caches=caches, cache_len=0,
                            attn_override=over)
        plain[run] = (x[:, -1] @ params["head"]["w"]).float()
    logits_p = plain[torch.float32]

    def rel_to_plain(logits):
        return float((logits - logits_p).norm() / logits_p.norm())

    rel = rel_to_plain(logits_k)
    faults = {f: rel_to_plain(plain[f]) for f in KV_FAULTS}
    agree = bool(logits_k.argmax() == logits_p.argmax())
    print(f"  prefill logits, flash_attention vs plain attention: relative L2 "
          f"{rel:.3g} (tolerance {KV_LOGIT_RTOL}; plain float64 vs float32 "
          f"attention {rel_to_plain(plain[torch.float64]):.3g}; planted "
          f"faults {', '.join(f'{f} {e:.3g}' for f, e in faults.items())}), "
          f"max |Δ| {float((logits_k - logits_p).abs().max()):.3g}, argmax "
          f"equal: {agree}")
    if not rel <= KV_LOGIT_RTOL:
        raise AssertionError(f"prefill logits differ: relative {rel}")
    if not min(faults.values()) > KV_LOGIT_RTOL:
        raise AssertionError(f"a planted fault passes the logit check: "
                             f"{faults}")
    del x, logits_k, logits_p, caches, plain

    # where the prefill's time goes: its wall time on a synchronized host
    # clock against the device time of its kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M.prefill_step(params, cfg, prompt)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_all = device_ms(lambda: M.prefill_step(params, cfg, prompt), 3)
    dev_fa = device_ms(lambda: M.prefill_step(params, cfg, prompt), 3,
                       "flash_attention_bf16_kernel")
    print(f"  prefill: wall {wall_ms:.2f} ms; device time of its kernels "
          f"{dev_all:.2f} ms, of which flash_attention {dev_fa:.2f} ms "
          f"({cfg.num_layers} calls); device busy {dev_all / wall_ms:.1%} "
          "of the wall")

    # the decode routine's host calls: a replayed step does not call it
    decode_calls = [0]
    real_decode = kv.kops.flash_centroid_decode

    def counted_decode(*args, **kwargs):
        decode_calls[0] += 1
        return real_decode(*args, **kwargs)

    runs, launches, calls = {}, {}, {}
    real_absorb = kv.kops.l2_absorb_heads
    kv.kops.flash_centroid_decode = counted_decode
    try:
        for run in ("exact", "clustered", "clustered, eager",
                    "clustered, unfused absorb",
                    "clustered, eager, unfused absorb"):
            mode = run.split(",")[0]
            kv.kops.l2_absorb_heads = unfused_absorb if "unfused" in run \
                else real_absorb
            reset_launches(*kernels)
            decode_calls[0] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = kv.clustered_decode(params, cfg, tokens, KV_PROMPT,
                                      mode=mode,
                                      gcfg=kv.default_kv_config(KV_KMAX),
                                      ema=KV_EMA, refresh_every=KV_REFRESH,
                                      device=dev,
                                      cuda_graph="eager" not in run)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[run] = {k.__name__: k.launches for k in kernels}
            calls[run] = decode_calls[0]
            runs[run] = out
            sec = out["seconds"]
            steps = np.array(sec["steps"])
            print(f"  {run}: {wall:.2f} s; prefill {sec['prefill']:.4f} s, "
                  f"fits {sec['fits']:.3f} s, decode step mean "
                  f"{steps.mean() * 1e3:.3f} ms (median "
                  f"{np.median(steps) * 1e3:.3f}, first "
                  f"{steps[0] * 1e3:.2f}, max {steps.max() * 1e3:.2f}), "
                  f"refresh {sec['refresh']:.3f} s; ppl {out['ppl']:.6f}; "
                  f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if mode == "clustered":
                print(f"    mean k* {out['mean_k_star']:.2f} (min "
                      f"{min(out['k_stars'])}, max {max(out['k_stars'])}), "
                      f"compression {out['compression']:.2f}, refreshes "
                      f"{out['refreshes']}, overflow "
                      f"{max(out['overflows'])}; decode-routine wrapper "
                      f"called {calls[run]} times on the host")
            print(f"    launches {launches[run]}")
    finally:
        kv.kops.flash_centroid_decode = real_decode
        kv.kops.l2_absorb_heads = real_absorb
    heads = cfg.num_layers * cfg.num_kv_heads
    per_run = cfg.num_layers * KV_DECODE
    clus = runs["clustered"]
    lx, lc = launches["exact"], launches["clustered"]
    clustered_runs = [r for r in runs if r != "exact"]
    if not all(math.isfinite(r["ppl"]) for r in runs.values()):
        raise AssertionError("non-finite perplexity")
    for run in clustered_runs:
        out = runs[run]
        if min(out["k_stars"]) <= 0 or max(out["overflows"]) != 0:
            raise AssertionError(f"{run}: a head has k* = 0 or overflow")
        if out["refreshes"] != heads * ((KV_DECODE - 1) // KV_REFRESH):
            raise AssertionError(f"{run}: refreshes {out['refreshes']}")
    if lx["flash_attention"] != cfg.num_layers or \
            lc["flash_attention"] != cfg.num_layers:
        raise AssertionError("flash_attention did not launch once a layer per "
                             "prefill")
    # one centroid attention a layer a step, all of it the decode kernel
    # (which flash_centroid_attention's count counts too), graph replays
    # counted; one absorb a layer a step (the unfused runs: one
    # head-batched route)
    if lc["flash_centroid_decode"] != per_run or \
            lc["flash_centroid_attention"] != per_run or \
            lx["flash_centroid_attention"] != 0:
        raise AssertionError("the decode kernel did not launch once a layer "
                             "per step")
    for run in clustered_runs:
        want = (0, per_run) if "unfused" in run else (per_run, 0)
        got = (launches[run]["l2_absorb_heads"],
               launches[run]["distance_argmin_l2_heads"])
        if got != want:
            raise AssertionError(f"{run}: absorb and head-batched route "
                                 f"launched {got} times, not {want}")
    if lc["distance_argmin_l2"] <= 0 or lc["minhash_segments"] <= 0:
        raise AssertionError("the fits did not run the L2 and MinHash kernels")
    # replayed, not eager: the wrapper ran at the first step and the capture
    for run in clustered_runs:
        if calls[run] != (per_run if "eager" in run else 2 * cfg.num_layers):
            raise AssertionError(f"{run}: the clustered step was not replayed "
                                 f"from its graph: {calls}")
    # the same kernels on the same inputs: the same bits; the absorb kernel
    # writes the unfused path's labels, centers, v_cent and mass, the
    # attention's inputs, so the same perplexity
    for run in clustered_runs[1:]:
        if runs[run]["k_stars"] != clus["k_stars"] or \
                runs[run]["ppl"] != clus["ppl"]:
            raise AssertionError(f"{run} differs from the clustered run: ppl "
                                 f"{runs[run]['ppl']} vs {clus['ppl']}")
    sx, sc, se, su, sue = (
        np.array(runs[r]["seconds"]["steps"]) * 1e3
        for r in ("exact", "clustered", "clustered, eager",
                  "clustered, unfused absorb",
                  "clustered, eager, unfused absorb"))
    print(f"  decode step, ms (mean / median): clustered, graph "
          f"{sc.mean():.3f} / {np.median(sc):.3f}; exact {sx.mean():.3f} / "
          f"{np.median(sx):.3f}; clustered, eager {se.mean():.3f} / "
          f"{np.median(se):.3f}; unfused absorb, graph {su.mean():.3f} / "
          f"{np.median(su):.3f}, eager {sue.mean():.3f} / "
          f"{np.median(sue):.3f}. Clustered / exact: "
          f"{sc.mean() / sx.mean():.3f} ({'below' if sc.mean() < sx.mean() else 'NOT below'}"
          f" the exact step); clustered / unfused median, graph: "
          f"{np.median(sc) / np.median(su):.3f} "
          f"({'no slower' if np.median(sc) <= np.median(su) else 'SLOWER'})."
          f" Graph vs eager, fused vs unfused absorb: ppl and k* equal "
          f"({clus['ppl']:.6f})")

    # the device's busy share of the decode steps: the device time of a
    # step's kernels, from profiled runs of KV_BUSY_STEPS steps (no refresh,
    # the first step, which captures, left out), over the mean step of the
    # runs above (steps 2-64); tracing slows the steps themselves, so the
    # share under the profiler is printed beside it. In the clustered
    # steps the trace counts the slice's two kernels: one of each a layer a
    # step, the replays' launches seen on the device
    from torch.profiler import ProfilerActivity, profile
    step_kernels = ("flash_centroid_decode_kernel", "l2_absorb_heads_kernel",
                    "l2_argmin_heads_kernel")
    # (each kernel's count a step: the decode kernel, the absorb kernel,
    # the head-batched route)
    nl = cfg.num_layers
    traces = (("clustered", sc, (nl, nl, 0)),
              ("clustered, unfused absorb", su, (nl, 0, nl)),
              ("exact", sx, (0, 0, 0)))
    for run, steps, wants in traces:
        mode = run.split(",")[0]
        kv.kops.l2_absorb_heads = unfused_absorb if "unfused" in run \
            else real_absorb
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                kv.clustered_decode(params, cfg,
                                    tokens[:, :KV_PROMPT + KV_BUSY_STEPS],
                                    KV_PROMPT, mode=mode,
                                    gcfg=kv.default_kv_config(KV_KMAX),
                                    ema=KV_EMA, refresh_every=KV_REFRESH,
                                    device=dev)
        finally:
            kv.kops.l2_absorb_heads = real_absorb
        busy, events, traced, named = busy_per_range(
            prof, kv.STEP_SPAN, skip=1, names=step_kernels)
        print(f"  {run} decode step, device: {busy:.3f} ms of kernels and "
              f"copies, {events:.0f} device events (torch.profiler, steps "
              f"2-{KV_BUSY_STEPS}); busy share {busy / steps[1:].mean():.1%}"
              f" of the untraced mean step {steps[1:].mean():.3f} ms "
              f"({busy / traced:.1%} of the traced step, {traced:.3f} ms)")
        for (name, counts), want in zip(named.items(), wants):
            if len(counts) != KV_BUSY_STEPS - 1 or set(counts) != {want}:
                raise AssertionError(f"{run}: {name} ran {counts} times in "
                                     f"the traced steps, not {want} a step")
        print(f"    traced on the device, a step: "
              f"{', '.join(f'{n} {c[0]}' for n, c in named.items())} "
              f"(in each of the {KV_BUSY_STEPS - 1} steps)")
    rows = decode_kernels(dev, cfg, clus["k_stars"][:cfg.num_kv_heads])
    # the head-batched route's count is the unfused run's: the fused main
    # path routes a step's rows in the absorb kernel
    rows[0]["launches"] = lc["l2_absorb_heads"]
    rows[1]["launches"] = \
        launches["clustered, unfused absorb"]["distance_argmin_l2_heads"]
    rows[2]["launches"] = lc["flash_centroid_decode"]

    # the first decode step of a few layers: each kv head fitted on its
    # prefill keys, the step's real queries and fresh K/V. The clustered
    # attention (no extra rows, float32) is held to the plain version on the
    # stacked state and to the error bound of exact attention over the raw
    # cache; the clustered step's own call (the model's dtype, the fresh
    # row appended unclustered) to the plain version on the same rows.
    caches = T.stack_cache_init(cfg, 1, KV_PROMPT + 1, dev)
    M.forward(params, cfg, prompt, caches=caches, cache_len=0)
    fit_kernels(dev, caches[0]["k"][0, :KV_PROMPT, 0].float(), int_rate)
    step_qkv = {}

    def capture(layer, p, h, *, positions, cache, cache_len):
        if layer in KV_BOUND_LAYERS:
            step_qkv[layer] = L.attn_qkv(p, h, cfg, positions=positions)
        return L.attn_apply(p, h, cfg, positions=positions, cache=cache,
                            cache_len=cache_len)

    M.decode_step(params, cfg, caches, KV_PROMPT,
                  tokens[:, KV_PROMPT:KV_PROMPT + 1], attn_override=capture)
    worst, plain_err, g = 0.0, 0.0, cfg.num_heads // cfg.num_kv_heads
    fit_abs_err = 0.0
    ulps, differ, elems = 0, 0, 0
    # the per-head API's path: OnlineKVCluster, stack_heads and
    # clustered_attention on the (B, S) kernel; its launches counted alone
    reset_launches(fa.flash_centroid_attention, fa.flash_centroid_decode)
    for layer in KV_BOUND_LAYERS:
        keys = caches[layer]["k"][0, :KV_PROMPT].float()
        vals = caches[layer]["v"][0, :KV_PROMPT].float()
        heads_ = []
        for h in range(cfg.num_kv_heads):
            cl = kv.OnlineKVCluster(kv.default_kv_config(KV_KMAX), ema=KV_EMA,
                                    seed=(0, layer, h), device=dev)
            cl.start(keys[:, h], vals[:, h])
            heads_.append(cl)
        q_step, k_step, v_step = step_qkv[layer]            # (1, 1, H, hd)
        q = q_step.float()
        state = kv.stack_heads(heads_)
        got = kv.clustered_attention(q, state)[0, 0]
        want = ref.centroid_attention_ref(
            q.transpose(1, 2), state.centers[None], state.v_cent[None],
            state.log_mass[None]).transpose(1, 2)[0, 0]
        plain_err = max(plain_err, fa_check(got, want, f"layer {layer}"))
        got_x = kv.clustered_attention(q_step, state, extra_k=k_step,
                                       extra_v=v_step)
        zero = torch.zeros((1, cfg.num_kv_heads, 1), device=dev)
        want_x = ref.centroid_attention_ref(
            q_step.transpose(1, 2),
            torch.cat([state.centers[None], k_step.float().transpose(1, 2)],
                      2),
            torch.cat([state.v_cent[None], v_step.float().transpose(1, 2)],
                      2),
            torch.cat([state.log_mass[None], zero], 2)).transpose(1, 2)
        if got_x.dtype != q_step.dtype:
            raise AssertionError(f"layer {layer}: the step's output is "
                                 f"{got_x.dtype}, not {q_step.dtype}")
        plain_err = max(plain_err, fa_check(got_x, want_x,
                                            f"layer {layer}, step"))
        # the same step through the decode kernel on the same state: the
        # two kernels sum in different orders, so their bf16 outputs may
        # differ in the last place (a witness, not a check)
        state_rows = [torch.stack([getattr(cl.layer, name)[0]
                                   for cl in heads_])
                      for name in ("centers", "v_cent", "mass",
                                   "center_valid")]
        got_d = fa.flash_centroid_decode(q_step, *state_rows, extra_k=k_step,
                                         extra_v=v_step)
        plain_err = max(plain_err, fa_check(got_d, want_x,
                                            f"layer {layer}, decode kernel"))
        # the absorb kernel on the same fitted state and the step's fresh
        # rows (the layer layout), held to the unfused path
        fitted = {name: torch.stack([getattr(cl.layer, name)[0]
                                     for cl in heads_])
                  for name in ABSORB_STATE}
        fit_abs_err = max(fit_abs_err, absorb_check(
            k_step[0].transpose(0, 1), v_step[0].transpose(0, 1), fitted,
            f"absorb, layer {layer}'s fitted state"))
        bits_x, bits_d = (t.view(torch.int16).int() for t in (got_x, got_d))
        differ += int((bits_x != bits_d).sum())
        elems += got_x.numel()
        ulps = max(ulps, int((bits_x - bits_d).abs().max()))
        for qh in range(cfg.num_heads):
            h = qh // g
            s = (keys[:, h].double() @ q[0, 0, qh].double()) \
                / math.sqrt(cfg.resolved_head_dim)
            want = torch.softmax(s, 0) @ vals[:, h].double()
            err = float((got[qh].double() - want).norm())
            bnd = heads_[h].error_bound(float(q[0, 0, qh].norm()))
            if not err <= bnd * (1 + 1e-5) + 1e-5:
                raise AssertionError(f"layer {layer} head {qh}: error {err} "
                                     f"above the bound {bnd}")
            worst = max(worst, err / bnd)
    tiles = fa.flash_centroid_attention.launches \
        - fa.flash_centroid_decode.launches
    if tiles != 2 * len(KV_BOUND_LAYERS):
        raise AssertionError(f"the per-head path launched the (B, S) kernel "
                             f"{tiles} times")
    print(f"  first decode step at layers {KV_BOUND_LAYERS}, all "
          f"{cfg.num_heads} heads, per-head API (OnlineKVCluster, "
          f"stack_heads, clustered_attention: {tiles} launches of the (B, S) "
          f"kernel): clustered attention vs plain max |Δ| "
          f"{plain_err:.3g} (float32, and the step's {cfg.dtype} with its "
          f"fresh row through both kernels); error bound held, largest error"
          f" / bound {worst:.3g}. The step's {cfg.dtype} output, decode "
          f"kernel vs (B, S) kernel: {differ} of {elems} elements differ, by "
          f"at most {ulps} ulp. The absorb kernel on each layer's fitted "
          f"state and the step's rows: the unfused path's bits, radii and "
          f"v_max max |Δ| {fit_abs_err:.3g}")
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], fit_abs_err)
    return {"flash_attention": lc["flash_attention"],
            "flash_centroid_attention": tiles}, rows


T0 = time.perf_counter()


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
            if "entry function" in line or "registers" in line or \
                    "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    # the bf16 flash routine runs its products on the tensor cores (HMMA)
    # and stages K and V by cp.async (LDGSTS)
    sass = build.sass_counts(build.library_path("flash_attention"),
                             "flash_attention_bf16_kernel", ("HMMA", "LDGSTS"))
    print(f"  SASS of flash_attention_bf16_kernel (dh 32, 64, 128): {sass}")
    if not (sass["HMMA"] and sass["LDGSTS"]):
        raise AssertionError("the bf16 flash kernel has no HMMA or LDGSTS")
    card = smi("name,power.limit")
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk_hz = float(smi("clocks.max.sm").split()[0]) * 1e6      # "1980 MHz"
    int_rate = INT32_PER_CLK * sms * clk_hz
    popc_rate = POPC_PER_CLK * sms * clk_hz
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {sms} SMs at {clk_hz / 1e6:.0f} "
          f"MHz max: {int_rate / 1e12:.2f} T int32 op/s, "
          f"{popc_rate / 1e12:.2f} T popc/s")
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
    # the layouts draw from a generator of their own, so that the main
    # paths' data stay those of earlier runs
    lgen = torch.Generator(device=dev).manual_seed(1)
    for name, (k, live) in DEAD_TILE_LAYOUTS.items():
        valid = live(torch.arange(k, device=dev))
        for n, d in LAYOUT_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((n, d), generator=lgen, device=dev).to(dtype)
                c = torch.randn((k, d), generator=lgen, device=dev).to(dtype)
                got = da.distance_argmin_l2(x, c, valid)
                if bool(valid.any()):
                    _, err = l2_agreement(x, c, valid, got,
                                          ref.distance_argmin_l2_ref(x, c,
                                                                     valid))
                    l2_err = max(l2_err, err)
                elif bool(got[0].any()) or not bool(
                        (got[1] == torch.finfo(torch.float32).max).all()):
                    raise AssertionError(f"{name}: no valid center, yet not "
                                         "label 0 and float32 max")
        print(f"  layout '{name}' (k={k}, {int(valid.sum())} valid) at "
              f"{LAYOUT_SHAPES}, float32 and bfloat16: within tolerance")
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

    phase("2b L2 assign-and-accumulate kernel vs plain")
    acc_err = 0.0
    for n, k, d in ACC_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
            c = torch.randn((k, d), generator=gen, device=dev).to(dtype)
            valid = torch.arange(k, device=dev) % 7 != 3
            acc_err = max(acc_err, acc_check(x, c, valid,
                                             f"({n},{k},{d}) {dtype}"))
        none = torch.zeros(k, dtype=torch.bool, device=dev)
        acc_err = max(acc_err, acc_check(x, c, none, f"({n},{k},{d}) none"))
        print(f"  ({n},{k},{d}) float32 and bfloat16, some and no valid "
              "centers: labels and d² equal the L2 kernel's, two calls "
              "equal, counts exact, sums equal their order rebuilt in "
              "float32 and within bound")
    for name, (k, live) in DEAD_TILE_LAYOUTS.items():
        valid = live(torch.arange(k, device=dev))
        for n, d in LAYOUT_SHAPES:
            x = torch.randn((n, d), generator=lgen, device=dev)
            c = torch.randn((k, d), generator=lgen, device=dev)
            acc_err = max(acc_err, acc_check(x, c, valid,
                                             f"'{name}' ({n},{k},{d})"))
    print(f"  the dead-tile layouts at {LAYOUT_SHAPES}, float32: the same "
          "checks hold")
    print(f"  sums' largest deviation from float64: {acc_err:.3g}")

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
    # 10 integer operations per hash: a multiply-add, three xor-shifts
    # (shift, xor), two multiplies and a min, K hashes per id; priced at
    # the 32-bit integer rate
    mh_ops = ids.numel() * cfg.silk_k * 10
    mh_bound, mh_by = bound(mh_bytes, [mh_ops / int_rate])
    print(f"  ({S} segments x {bsz} ids, K={cfg.silk_k}): bit-exact; kernel "
          f"{mh_ms:.4f} ms, plain {mh_plain_ms:.3f} ms, bound "
          f"{mh_bound:.4f} ms ({mh_by}: {mh_bytes / 1e6:.1f} MB)")
    del ids, offsets, sig_k, sig_p

    # a one-rank NCCL group for the multi-device paths: a FileStore in a
    # temporary directory, no network
    import torch.distributed as dist
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as rdv_dir:
        dist.init_process_group("nccl", init_method=f"file://{rdv_dir}/rdv",
                                rank=0, world_size=1)
        try:
            # NCCL sets its communicator up at the first collective: do
            # that here, outside the timed paths
            dist.all_reduce(torch.zeros(1, device=dev))
            torch.cuda.synchronize()
            return run_paths(rt, dev, gen, card, int_rate, popc_rate, data,
                             x_fit, x_new, cfg, l2_err, acc_err, mh_err,
                             mh_ms, mh_plain_ms, mh_bound, mh_by)
        finally:
            dist.destroy_process_group()


def run_paths(rt, dev, gen, card, int_rate, popc_rate, data, x_fit, x_new,
              cfg, l2_err, acc_err, mh_err, mh_ms, mh_plain_ms, mh_bound,
              mh_by):
    """The main paths (phases 4-9, with the sharded and table-sync paths
    beside them), then the kernels line and the last line."""
    from repro_torch.core import assign
    from repro_torch.data.synthetic import geonames_like, url_like
    from repro_torch.kernels import build
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import distance_argmin_hamming as dh
    from repro_torch.kernels import minhash_buckets as mh
    from repro_torch.kernels import pack, ref
    all_kernels = (da.distance_argmin_l2, da.distance_argmin_l2_accumulate,
                   dh.distance_argmin_hamming,
                   dh.distance_argmin_hamming_packed, mh.minhash_segments)
    mesh = rt.make_mesh()

    phase("4 main path: GEEK(cfg).fit + predict at 1M x 128")
    print(f"  config {cfg}")
    reset_launches(*all_kernels)
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
    dense_fit_s = fit_s
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
    live = cen[cv].contiguous()
    l2_live_ms = cuda_ms(lambda: x_fit @ live.T, 20)
    every = torch.ones_like(cv)
    l2_all_ms = cuda_ms(lambda: da.distance_argmin_l2(x_fit, cen, every), 10)
    kv = int(cv.sum())
    l2_flops = 2.0 * N_FIT * kv * D
    l2_bytes = 4.0 * (N_FIT * D + cen.numel() + 2 * cen.shape[0] + 2 * N_FIT)
    l2_bound = max(l2_flops / PEAK_F32_FLOPS, l2_bytes / PEAK_BYTES) * 1e3
    l2_by = "operations" if l2_flops / PEAK_F32_FLOPS >= l2_bytes / PEAK_BYTES \
        else "bytes"
    print(f"  L2 at ({N_FIT},{cen.shape[0]},{D}), {kv} valid: kernel "
          f"{l2_ms:.3f} ms, plain {l2_plain_ms:.3f} ms, x @ c.T "
          f"{l2_lib_ms:.3f} ms (all {cen.shape[0]} centers), x @ c[cv].T "
          f"{l2_live_ms:.3f} ms ({kv} live), bound {l2_bound:.3f} ms "
          f"({l2_by}); every center valid: kernel {l2_all_ms:.3f} ms")
    del live, every

    phase("4b sharded dense path: fit(mesh=) + make_predict_sharded, g=1 NCCL")
    dense_sh_launch, dense_sh_s = sharded_check(
        "dense", est, rt.DenseData(x_fit), model, res, rt.DenseData(x_new),
        mesh, all_kernels, da.distance_argmin_l2)

    phase(f"4c table-sync path: make_fit_dense at {N_FIT:,} x {D}, "
          f"{REFINE_SWEEPS} refine sweeps, g=1 NCCL")
    reset_launches(*all_kernels)
    ts_runs = {}
    for compress in (False, True):
        ts_cfg = rt.GeekConfig(pair_cap=1 << 21, refine_sweeps=REFINE_SWEEPS,
                               compress_collectives=compress)
        before = da.distance_argmin_l2_accumulate.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ts = rt.make_fit_dense(mesh, ts_cfg)(x_fit, 0)
        torch.cuda.synchronize()
        ts_s = time.perf_counter() - t0
        sweeps = da.distance_argmin_l2_accumulate.launches - before
        ks, ovf = int(ts.k_star), int(ts.overflow)
        pur = purity(ts.labels, data.true_labels[:N_FIT], ts_cfg.k_max)
        print(f"  compress_collectives={compress}: fit {ts_s:.3f} s, k*={ks}, "
              f"overflow={ovf}, purity {pur:.4f}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"accumulate kernel launches {sweeps}")
        if sweeps != REFINE_SWEEPS:
            raise AssertionError(f"the table-sync fit launched the accumulate "
                                 f"kernel {sweeps} times, not {REFINE_SWEEPS}")
        if ks <= 0 or ovf != 0 or ts.labels.shape != (N_FIT,) or not bool(
                torch.isfinite(ts.centers[ts.center_valid]).all()):
            raise AssertionError(f"table-sync fit: k*={ks}, overflow={ovf}")
        ts_runs[compress] = ts
    ts_launch = {k.__name__: k.launches for k in all_kernels}
    print(f"  launches over both fits {ts_launch}")
    # the accumulating kernel at the table-sync fit's own inputs: its rows
    # and its centers (k* of k_max valid)
    cen, cv = ts_runs[False].centers, ts_runs[False].center_valid
    acc_err = max(acc_err, acc_check(x_fit, cen, cv, "table-sync inputs"))
    acc_ms = cuda_ms(lambda: da.distance_argmin_l2_accumulate(x_fit, cen, cv),
                     20)
    acc_plain_ms = cuda_ms(lambda: assign.assign_l2_with_partials(x_fit, cen,
                                                                  cv), 5)
    kv = int(cv.sum())
    k_ = cen.shape[0]
    # 2·n·k_valid·d for the distances and n·d adds for the sums; each input
    # read once (x, centers, ‖c‖², validity), each output written once
    # (labels, d², sums, counts)
    acc_bound, acc_by = bound(
        4.0 * (N_FIT * D + k_ * D + 2 * k_ + 2 * N_FIT + k_ * D + k_),
        [(2.0 * N_FIT * kv * D + N_FIT * D) / PEAK_F32_FLOPS])
    print(f"  accumulate kernel at ({N_FIT},{k_},{D}), {kv} valid: kernel "
          f"{acc_ms:.3f} ms, plain {acc_plain_ms:.3f} ms, bound "
          f"{acc_bound:.3f} ms ({acc_by}); no single library call computes "
          f"the assignment and the per-cluster sums; sums equal their order "
          f"rebuilt in float32, largest deviation from float64 "
          f"{acc_err:.3g}")
    del ts_runs, cen, cv

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
    del data, x_fit, x_new, model, res, est, back, lab_fit, lab_new
    torch.cuda.empty_cache()

    phase("6 Hamming kernels vs plain (bit-exact)")
    ham_err = packed_err = 0.0
    for n, k, d, card_ in HAM_SHAPES:
        codes = torch.randint(0, card_, (n, d), generator=gen, device=dev,
                              dtype=torch.int32)
        cen = torch.randint(0, card_, (k, d), generator=gen, device=dev,
                            dtype=torch.int32)
        codes[::3] = cen[torch.randint(0, k, (codes[::3].shape[0],),
                                       generator=gen, device=dev)]
        for mode in ("some", "none"):
            valid = (torch.arange(k, device=dev) % 7 != 3) if mode == "some" \
                else torch.zeros(k, dtype=torch.bool, device=dev)
            plain = (ref.distance_argmin_hamming_ref(codes, cen, valid)
                     if n * k * d <= 2**27 else
                     assign.assign_hamming(codes, cen, valid, block=1024))
            ham_err = max(ham_err, ham_exact(
                dh.distance_argmin_hamming(codes, cen, valid), plain,
                f"equality ({n},{k},{d}) {mode} valid"))
        print(f"  equality ({n},{k},{d}, card {card_}): bit-exact, with and "
              "without valid centers")

    def packed_inputs():
        """(what, codes, centers, valid, bits): the random sweep, whose
        counts are also held to the equality kernel's plain version, then
        the edge cases."""
        for n, k, d, bits in PACKED_SHAPES:
            hi = 2**32 if bits == 32 else 1 << bits
            codes = torch.randint(0, hi, (n, d), generator=gen, device=dev)
            cen = torch.randint(0, hi, (k, d), generator=gen, device=dev)
            codes[::3] = cen[0]
            codes[1] = hi - 1
            yield (f"({n},{k},{d})", codes, cen,
                   torch.arange(k, device=dev) % 7 != 3, bits)
        # a generator of their own: the later phases draw from ``gen`` what
        # they drew before these cases were added
        case_gen = torch.Generator(device=dev).manual_seed(6)
        for case in pack.PACKED_CASES:
            for bits in pack.SUPPORTED_BITS:
                codes, cen, valid = pack.packed_case(case, bits, 3_000,
                                                     case_gen)
                yield (f"{case} ({codes.shape[0]},{cen.shape[0]},"
                       f"{codes.shape[1]})", codes, cen, valid, bits)

    for what, codes, cen, some, bits in packed_inputs():
        (n, d), k = codes.shape, cen.shape[0]
        xp, cp = pack.pack_codes(codes, bits), pack.pack_codes(cen, bits)
        if d * bits >= 32 and int(xp.min()) >= 0:
            raise AssertionError("no packed word has its top bit set")
        for mode in ("some", "none"):
            valid = some if mode == "some" \
                else torch.zeros(k, dtype=torch.bool, device=dev)
            for dd in (d, None):
                plain = ref.distance_argmin_hamming_packed_ref(
                    xp, cp, valid, bits=bits, d=dd)
                packed_err = max(packed_err, ham_exact(
                    dh.distance_argmin_hamming_packed(xp, cp, valid, bits=bits,
                                                      d=dd), plain,
                    f"packed {what} {bits} bits {mode} valid"))
            if what.startswith("("):
                eq = ref.distance_argmin_hamming_ref(codes, cen, valid)
                ham_exact(dh.distance_argmin_hamming_packed(
                    xp, cp, valid, bits=bits, d=d), eq,
                    f"packed vs equality {what} {bits} bits")
        print(f"  packed {what}, {xp.shape[1]} words of {bits}-bit fields: "
              "bit-exact, with and without valid centers")

    phase(f"7 heterogeneous main path: fit + predict at {N_HET:,} x (5 + 4)")
    het_cfg = rt.GeekConfig(pair_cap=1 << 24)
    print(f"  config {het_cfg}")
    h = geonames_like(gen, n=N_HET + N_FRESH, k=K_HET)
    het_fit = rt.HeteroData(h.x_num[:N_HET], h.x_cat[:N_HET])
    het_est = rt.GEEK(het_cfg)
    het_model, het_launch, het_fit_s = code_path(
        all_kernels, "hetero", het_est, het_fit,
        rt.HeteroData(h.x_num[N_HET:], h.x_cat[N_HET:]),
        h.true_labels[:N_HET], h.true_labels[N_HET:], K_HET,
        dh.distance_argmin_hamming)
    # the equality kernel at the path's own inputs: the coded fit rows and
    # the fitted modes (k* of k_max valid: the work the data needs)
    codes = het_model.encode(h.x_num[:N_HET], h.x_cat[:N_HET])
    cen, cv = het_model.centers, het_model.center_valid
    ham_err = max(ham_err, ham_exact(
        dh.distance_argmin_hamming(codes, cen, cv),
        assign.assign_hamming(codes, cen, cv), "equality at the main path"))
    eq_ms = cuda_ms(lambda: dh.distance_argmin_hamming(codes, cen, cv), 10)
    eq_plain_ms = cuda_ms(lambda: assign.assign_hamming(codes, cen, cv), 1)
    eq_lib_ms = cuda_ms(lambda: torch.cdist(codes.float(), cen.float(), p=0),
                        3)
    kv, (n_, d_) = int(cv.sum()), codes.shape
    # per (row, valid center): d compares, d adds and the running min
    # (EQUALITY_OPS); each input read once, labels and counts written
    eq_bound, eq_by = bound(
        4.0 * (n_ * d_ + cen.numel() + cv.numel() + 2 * n_),
        hamming_op_times(n_ * kv, d_, EQUALITY_OPS, int_rate, popc_rate))
    print(f"  equality kernel at ({n_},{cen.shape[0]},{d_}), {kv} valid: "
          f"bit-exact vs plain; kernel {eq_ms:.3f} ms, plain (blocked) "
          f"{eq_plain_ms:.3f} ms, cdist(p=0) {eq_lib_ms:.3f} ms, bound "
          f"{eq_bound:.3f} ms ({eq_by})")
    del codes
    het_sh_launch, het_sh_s = sharded_check(
        "hetero", het_est, het_fit, het_model, het_est.result_,
        rt.HeteroData(h.x_num[N_HET:], h.x_cat[N_HET:]), mesh, all_kernels,
        dh.distance_argmin_hamming)
    del h, het_fit
    torch.cuda.empty_cache()

    phase(f"8 sparse main path: fit + predict at {N_URL:,} sets x {NNZ_URL}")
    url_cfg = rt.GeekConfig(pair_cap=1 << 22)
    print(f"  config {url_cfg}")
    u = url_like(gen, n=N_URL + N_FRESH, k=K_URL, nnz=NNZ_URL, universe=U_URL)
    url_fit = rt.SparseData(u.sets[:N_URL], u.mask[:N_URL])
    url_est = rt.GEEK(url_cfg)
    url_model, url_launch, url_fit_s = code_path(
        all_kernels, "sparse", url_est, url_fit,
        rt.SparseData(u.sets[N_URL:], u.mask[N_URL:]),
        u.true_labels[:N_URL], u.true_labels[N_URL:], K_URL,
        dh.distance_argmin_hamming_packed)
    # the packed kernel at the path's own inputs: the fit rows' packed DOPH
    # codes (int32 words, as predict packs them) and the fitted modes
    bits, d_ = url_model.code_bits, url_model.d
    xp = pack.pack_codes(url_model.encode(u.sets[:N_URL], u.mask[:N_URL]),
                         bits)
    pcen, cv = url_model.packed_centers, url_model.center_valid
    packed_err = max(packed_err, ham_exact(
        dh.distance_argmin_hamming_packed(xp, pcen, cv, bits=bits, d=d_),
        assign.assign_hamming_packed(xp, pcen, cv, bits=bits, d=d_),
        "packed at the main path"))
    pk_ms = cuda_ms(lambda: dh.distance_argmin_hamming_packed(
        xp, pcen, cv, bits=bits, d=d_), 10)
    pk_dev_ms = device_ms(lambda: dh.distance_argmin_hamming_packed(
        xp, pcen, cv, bits=bits, d=d_), 10, "Packed")
    pk_plain_ms = cuda_ms(lambda: assign.assign_hamming_packed(
        xp, pcen, cv, bits=bits, d=d_), 1)
    kv, (n_, w_) = int(cv.sum()), xp.shape
    # per (row, valid center): w words at the fewest ops a word needs, by
    # pipe (PACKED_OPS), plus the running min; each input read once,
    # labels and counts written
    pk_bound, pk_by = bound(
        4.0 * (n_ * w_ + pcen.numel() + cv.numel() + 2 * n_),
        hamming_op_times(n_ * kv, w_, PACKED_OPS[bits], int_rate, popc_rate))
    print(f"  packed kernel at ({n_},{pcen.shape[0]},{w_} words of {bits}-bit "
          f"fields), {kv} valid: bit-exact vs plain; kernel {pk_ms:.4f} ms "
          f"(device {pk_dev_ms:.4f}), plain (blocked) {pk_plain_ms:.3f} ms, "
          f"bound {pk_bound:.4f} ms ({pk_by}): {pk_bound / pk_ms:.1%} of it "
          f"({pk_bound / pk_dev_ms:.1%} by device time), {card}; no single "
          "library call computes it")
    print("  SASS of the packed kernel at 16-bit fields, 32-word chunks: "
          + str(build.sass_counts(build.library_path("distance_argmin_hamming"),
                            "PackedILi16EEELi32E",
                            ("LOP3", "IADD3", "VIADD", "IMAD", "SHF", "POPC",
                             "LEA"))))
    del xp
    url_sh_launch, url_sh_s = sharded_check(
        "sparse", url_est, url_fit, url_model, url_est.result_,
        rt.SparseData(u.sets[N_URL:], u.mask[N_URL:]), mesh, all_kernels,
        dh.distance_argmin_hamming_packed)
    del url_fit

    phase("9 code-space checkpoints")
    for name, est_, m_, q in (
            ("hetero", het_est, het_model, rt.HeteroData(
                *geonames_like(gen, n=4096, k=K_HET)[:2])),
            ("sparse", url_est, url_model, rt.SparseData(
                *url_like(gen, n=4096, k=K_URL, nnz=NNZ_URL,
                          universe=U_URL)[:2]))):
        with tempfile.TemporaryDirectory() as tmp:
            rt.save_model(tmp, m_)
            back = rt.restore_model(tmp)
            if back.centers.dtype != torch.int32:
                raise AssertionError(f"{name}: centers restored as "
                                     f"{back.centers.dtype}")
            if not torch.equal(est_.predict(q, model=back)[0],
                               est_.predict(q)[0]):
                raise AssertionError(f"{name}: save/restore changed labels")
        print(f"  {name}: port save_model -> restore_model: labels identical")
    for name in ("geek_ref_hetero", "geek_ref_sparse"):
        path = os.path.join(DATA, name)
        m_ = rt.restore_model(os.path.join(path, "ckpt"))
        if name == "geek_ref_hetero":
            got, dist = rt.GEEK(rt.GeekConfig()).predict(rt.HeteroData(
                np.load(os.path.join(path, "x_num.npy")),
                np.load(os.path.join(path, "x_cat.npy"))), model=m_)
        else:
            got, dist = rt.predict(m_, np.load(os.path.join(path, "codes.npy")))
        want = torch.from_numpy(np.load(os.path.join(path, "labels.npy")))
        want_d = torch.from_numpy(np.load(os.path.join(path, "dists.npy")))
        if not (torch.equal(got.cpu(), want) and torch.equal(dist.cpu(),
                                                             want_d)):
            raise AssertionError(f"{name}: reference labels/distances not "
                                 "reproduced exactly")
        print(f"  {name} (k_max={m_.k_max}, d={m_.d}, {m_.impl}): "
              f"{want.numel()} labels and distances reproduced exactly")

    print(f"  fit s: dense {dense_fit_s:.3f}, hetero {het_fit_s:.3f}, "
          f"sparse {url_fit_s:.3f}; sharded at g=1: dense {dense_sh_s:.3f}, "
          f"hetero {het_sh_s:.3f}, sparse {url_sh_s:.3f}")
    del u, het_model, url_model, het_est, url_est
    torch.cuda.empty_cache()
    flash_rows = flash_phase(dev, gen)
    kv_launch, decode_rows = kv_path(rt, dev, gen, all_kernels, int_rate)
    kernels = [
        {"name": "distance_argmin_l2", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:188",
         "launches": launches["l2"], "max_abs_err": l2_err, "ms": l2_ms,
         "plain_ms": l2_plain_ms, "bound_ms": l2_bound, "bound_by": l2_by,
         "library_ms": l2_lib_ms},
        {"name": "distance_argmin_l2_accumulate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:207",
         "launches": ts_launch["distance_argmin_l2_accumulate"],
         "max_abs_err": acc_err, "ms": acc_ms, "plain_ms": acc_plain_ms,
         "bound_ms": acc_bound, "bound_by": acc_by, "library_ms": None},
        {"name": "distance_argmin_hamming", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin_hamming.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:278",
         "launches": het_launch["distance_argmin_hamming"],
         "max_abs_err": ham_err, "ms": eq_ms, "plain_ms": eq_plain_ms,
         "bound_ms": eq_bound, "bound_by": eq_by, "library_ms": eq_lib_ms},
        {"name": "distance_argmin_hamming_packed", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin_hamming.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:370",
         "launches": url_launch["distance_argmin_hamming_packed"],
         "max_abs_err": packed_err, "ms": pk_ms, "plain_ms": pk_plain_ms,
         "bound_ms": pk_bound, "bound_by": pk_by, "library_ms": None},
        {"name": "minhash_even_buckets", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/minhash_buckets.cu",
         "replaces": "src/repro/kernels/minhash_buckets.py:58",
         "launches": (launches["minhash"] + het_launch["minhash_segments"]
                      + url_launch["minhash_segments"]),
         "max_abs_err": mh_err, "ms": mh_ms,
         "plain_ms": mh_plain_ms, "bound_ms": mh_bound, "bound_by": mh_by,
         "library_ms": None},
    ]
    for row in flash_rows:
        row["launches"] = kv_launch[row["name"]]
    print(f"smoke wall {time.perf_counter() - T0:.1f} s")
    kernels += flash_rows + decode_rows
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
