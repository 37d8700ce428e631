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

the SILK bucket MinHash kernel on all three. Phase 3 holds that kernel to
its plain version on every layout of ``minhash_buckets.MINHASH_CASES``
and on a code-space-shaped CSR of 40,000,000 mostly empty segments with
buckets of 10,000-60,000 ids; phases 7 and 8 record the SILK inputs of
the hetero and sparse fits and print their segment sizes and the
kernel's times there beside its bound. Then the multi-device paths,
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

Then the center index (phase 12): ``predict(probes=0, 1)`` on the three
fitted models and on a 16,384-center model (768 candidates a row) against
the kernels' exact labels, the index rebuilt through save and restore,
a layer's heads routed through their indexes, and ``clustered_decode``
with ``probes=1`` equal to the clustered run; and the streaming fit
(phase 13): ``fit(chunk=)`` on the three kinds (arrays, ragged chunk
pieces, ``seed_cap=``, ``mesh=``) against the in-core fits bit for bit,
with the pass's device memory, and ``GEEK.predict(batch=)``.

Then the serving tier (phase 14) on the fitted models at the reference's
defaults (``max_batch`` 4,096, 5 ms deadline): fresh raw rows in requests
of log-uniform sizes through ``ClusterServer`` (dense exact with a
``swap()`` halfway, to phase 13's seed-capped streamed model, and probed;
hetero; sparse), a two-worker ``WorkerPool`` on the one card, a
``ClusterFrontend`` on loopback and a ``RefitAutopilot`` refit beside a
live stream, every request's labels equal to ``predict`` of the version
it reports; and the §4.1 baselines (phase 15) at k = 1,024 on phase 4's
rows and phase 7's codes (``seed_then_assign`` by k-means++, k-means‖ and
random, Lloyd, sampled k-means, k-modes), each through the kernels and
through the plain path on the card from the same generator state.

Then the rest of the LM substrate (phase 16): Jamba-v0.1 at full width
cut to one period of its 1:7 interleave (8 of 32 layers: Mamba mixers,
attention at layer 4, MoE at the odd layers; 13.3B parameters, bf16)
through ``clustered_decode`` with phase 11's harness, its prefill held to
the plain attention and its graph-replayed clustered run to the eager
one, with the MoE layers' drops and each stage's time; RWKV6-1.6B whole,
its chunked prefill held to the step recurrence, and its exact decode;
and the ten architectures' smoke configs in float32 and bf16, card
against CPU.

Then training (phase 17): Qwen3-0.6B whole (bf16, remat on) at a
4,096-token sequence and a global batch of 8 (two micro-batches of 4),
AdamW, through the trainer ``repro_torch.launch.train``: 8 steps
unbroken, and 4 steps, an async checkpoint, a restore into fresh
parameters and steps 5-8, which must end bit for bit where the unbroken
run ends (deterministic algorithms), the loss falling; where a
micro-batch's time goes; every smoke config's train step, card against
CPU; ``--mode ddp-compress`` on the one-rank NCCL group against gloo on
the CPU; and the serving launcher ``repro_torch.launch.serve`` at full
width (prefill of 4 x 2,048 on the flash-attention kernel, 16 tokens
decoded), its decode logits held to a full forward's, and the
flash-attention kernel refusing an input that requires grad.

Then the trainer's mesh mode (phase 18): Qwen3-0.6B whole through
``repro_torch.launch.train --mesh 1x1`` on the one-rank NCCL group (its
parameters, AdamW state and batch DTensors on a (data, model) DeviceMesh,
the step under ``activation_sharding``), two steps at phase 17's
micro-batch shape, held to the single-card trainer from the same weights
and batch (bit for bit or within phase 17(b)'s rule), with each mode's
step time and peak memory; one step of each mode traced by
``torch.profiler`` (the device's idle share, the kernels and the host's
aten ops); and the ten full-width configs' spec trees resolved to local
shapes on that mesh.

All data is generated from a seed, not downloaded. It checks that each
path launched its kernels, round-trips checkpoints, and reproduces the
labels of models fitted and saved by the JAX reference
(``tests/data/geek_ref_{dense,hetero,sparse}``).
Any failure raises and exits non-zero. The line before the last is a
JSON object with each kernel's launches, error, times and bound; the
last line is ``{"ok": true, "device": {...}}``.

Imports only torch, numpy, the standard library and ``repro_torch``.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types

# phase 17 trains under torch.use_deterministic_algorithms, which needs a
# fixed cuBLAS workspace; cuBLAS reads this when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
# same per column: ISETP, then an add predicated on it, which the
# equality kernel's SASS issues as VIADD off the integer pipe (9 of each
# a pair at d = 9; the kernel would take at least 2.33 ms at (2M, 1,024,
# 9) were the VIADD on the integer pipe, and takes 1.48 on an H100). Both
# keep a running minimum: with a center's count and index in one key
# (count * tile + index), one min a (row, center), VIMNMX on the integer
# pipe, as the equality kernel's SASS shows it.
PACKED_OPS = {1: (1, 1, 1), 2: (3, 2, 0.75), 4: (3, 2, 0.75),
              8: (3, 2, 0.75), 16: (3, 2, 0.75), 32: (1, 1, 0)}
EQUALITY_OPS = (1, 1)


#: the equality kernel at the heterogeneous path's width (d = 9), and the
#: opcodes its SASS is counted by (Hopper's min is VIMNMX)
EQ_KERNEL9 = "equality_argmin_kernelILi9E"
EQ_OPCODES = ("ISETP", "SEL", "IADD3", "IMAD", "LOP3", "IMNMX", "VIMNMX",
              "LDS", "VIADD")
#: a column's compare: ISETP.NE of two registers (the kernels' other
#: compares test against RZ or an immediate, or are not ISETP.NE)
COLUMN_COMPARE = re.compile(r"ISETP\.NE\.AND P\d, PT, R\d+(\.reuse)?, "
                            r"R\d+(\.reuse)?, PT")


def equality_sass(lib, source):
    """({opcode: count} of the d = 9 equality kernel in the library
    ``lib``, its column compares a (row, center) pair): the compares over
    the pairs of one step of its inner loop, EQ_ROWS rows x EQ_UNROLL
    centers, read from the kernel's ``source`` text."""
    from repro_torch.kernels import build
    text = build.sass(lib, EQ_KERNEL9)
    counts = {op: text.count(f" {op}") for op in EQ_OPCODES}
    rows, unroll = (int(re.search(rf"constexpr int {name} = (\d+);",
                                  source).group(1))
                    for name in ("EQ_ROWS", "EQ_UNROLL"))
    return counts, len(COLUMN_COMPARE.findall(text)) / (rows * unroll)


def hamming_op_times(pairs, words, ops, int_rate, popc_rate):
    """Seconds of each pipe for ``pairs`` (row, valid center) pairs of
    ``words`` columns at ``ops`` = (integer, FMA, popc) a column, plus the
    running minimum's one min a pair on the integer pipe."""
    ints, fmas, popcs = (*ops, 0)[:3]
    return [pairs * (words * ints + 1) / int_rate,
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


#: traces ``device_ms`` takes before it gives up on finding a kernel
DEVICE_TRACES = 3


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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
    call (its events over the loop's calls, rounded, at least 1). Even
    so a trace of a short loop can come back without the kernel (it has,
    at phase 11's fit inputs, and three times running at phase 16's
    flash inputs): it is taken again over a loop 4 times as long, up to
    ``DEVICE_TRACES`` times in all, before this raises."""
    from torch.profiler import ProfilerActivity, profile, schedule
    names = match if isinstance(match, tuple) else (match,)
    fn()
    torch.cuda.synchronize()
    for attempt in range(DEVICE_TRACES):
        calls = iters * 4 ** attempt
        traced = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.extend(p.key_averages())
                     ) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        total = 0.0
        for e in traced:
            if any(m in e.key for m in names) and \
                    e.self_device_time_total > 0:
                per_call = max(1, round(e.count / calls))
                total += e.self_device_time_total / e.count * per_call
        if total > 0.0:
            return total / 1e3
        print(f"  (a device trace held no kernel named like {match!r}; "
              "tracing again)")
    raise AssertionError(f"no kernel named like {match!r} was traced in "
                         f"{DEVICE_TRACES} traces")


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


def kept(model, res, cfg, data, fit_s, parts, fresh):
    """What phases 12 and 13 need of a code-space path: its model, its
    in-core result, its rows and fresh rows on the host."""
    return dict(model=model, cfg=cfg, data=data, fit_s=fit_s,
                parts=tuple(p.cpu().numpy() for p in parts),
                fresh=tuple(p.cpu().numpy() for p in fresh),
                labels=res.labels.cpu(), dists=res.dists.cpu(),
                radius=model.radius.cpu(), centers=model.centers.cpu(),
                center_valid=model.center_valid.cpu(), k_star=int(res.k_star))


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


#: the segment-size classes a MinHash input is binned by: (label, least,
#: most ids; None: no most)
MH_SIZE_BINS = (("0", 0, 0), ("1", 1, 1), ("2-8", 2, 8), ("9-32", 9, 32),
                ("33-1,024", 33, 1024), ("> 1,024", 1025, None))
#: the device kernels of one ``minhash_segments`` call: the kernel's own,
#: and the fill that zeroes the lane route's work list
MH_KERNELS = ("minhash", "FillFunctor")


def minhash_bound(ids, offsets, keys, int_rate):
    """(bound ms, by) of one ``minhash_segments`` call: the ids its
    segments cover and the offsets read once (4 bytes each), the keys, the
    signatures written once as the int64 carrier (8 bytes); 10 integer
    operations a hash (a multiply-add, three xor-shifts, two multiplies
    and a min), K hashes an id, at the 32-bit integer rate."""
    covered = int(offsets[-1] - offsets[0])
    segs = offsets.numel() - 1
    return bound(4.0 * (covered + offsets.numel() + keys.numel()) + 8.0 * segs,
                 [covered * keys.shape[0] * 10 / int_rate])


def mh_sizes(offsets):
    """One line on a MinHash input's segments: S, the ids P they cover,
    the empty share, how many fall in each of ``MH_SIZE_BINS``, and the
    largest."""
    sizes = offsets[1:] - offsets[:-1]
    S, P = sizes.numel(), int(offsets[-1] - offsets[0])
    hist = {label: int(((sizes >= lo) & (sizes <= (hi if hi is not None
                                                   else sizes.max()))).sum())
            for label, lo, hi in MH_SIZE_BINS}
    return (f"S {S:,}, P {P:,}, empty share {hist['0'] / max(S, 1):.4f}, "
            f"segments by ids {hist}, largest {int(sizes.max()):,}")


def record_minhash(fit):
    """Call ``fit()`` with the first (ids, offsets, keys) that SILK hands
    to ``ops.minhash_segments`` recorded (the seeding rounds share ids and
    offsets). Returns (what ``fit()`` returns, the recorded arguments)."""
    from repro_torch.core import silk
    seen = []
    real = silk.kops.minhash_segments

    def spy(*args):
        if not seen:
            seen.append(args)
        return real(*args)
    silk.kops.minhash_segments = spy
    try:
        out = fit()
    finally:
        silk.kops.minhash_segments = real
    if not seen:
        raise AssertionError("the fit handed SILK's MinHash nothing")
    return out, seen[0]


def minhash_at(what, args, int_rate, card):
    """Row 5 at one input: its segments (``mh_sizes``), the kernel held bit
    for bit to its plain version, its time back to back and its device
    time alone beside its bound. Launches here are not the main path's:
    call it after a path's counts were read. Returns (ms, device ms,
    bound ms)."""
    from repro_torch.kernels import minhash_buckets as mh
    from repro_torch.kernels import ref
    ids, offsets, keys = args
    print(f"  MinHash input of {what}: {mh_sizes(offsets)}; "
          f"{'a lane' if mh.lane_layout(ids.numel(), offsets.numel() - 1) else 'a warp'}"
          " a segment")
    if not torch.equal(mh.minhash_segments(*args),
                       ref.minhash_segments_ref(*args)):
        raise AssertionError(f"MinHash differs from plain at {what}'s input")
    ms = cuda_ms(lambda: mh.minhash_segments(*args), 20)
    dev_ms = device_ms(lambda: mh.minhash_segments(*args), 10, MH_KERNELS)
    b, by = minhash_bound(ids, offsets, keys, int_rate)
    print(f"  minhash_segments at {what}'s input, K={keys.shape[0]}: "
          f"bit-exact vs plain; {ms:.4f} ms back to back, device {dev_ms:.4f}"
          f" ms, bound {b:.4f} ms ({by}): {b / dev_ms:.1%} of it by device "
          f"time, {card}")
    return ms, dev_ms, b


def code_space_layout(gen, tables=20, n=2_000_000):
    """(ids, offsets) shaped like the code-space fits' SILK input:
    ``tables`` tables of n buckets over n ids each (tables·n segments).
    Each table's ids fill its first 40,000 buckets, sized like u³·200 (u
    uniform: mostly small, a fifth empty), with 8 buckets of 10,000-60,000
    ids among them and segments at the kernel's thresholds first; ids
    past n are cut, ids short of it go to singletons; the tail is empty."""
    from repro_torch.kernels import minhash_buckets as mh
    dev = gen.device
    head = 40_000
    T, C = mh.SHORT_MAX, mh.CHUNK
    edge = torch.tensor([T - 1, T, T + 1, C - 1, C, C + 1, 2 * C, 2 * C + 1],
                        device=dev)
    raw = (torch.rand((tables, head), generator=gen, device=dev) ** 3
           * 200).long()
    raw[:, :edge.numel()] = edge
    big = torch.randint(edge.numel(), head, (tables, 8), generator=gen,
                        device=dev)
    raw.scatter_(1, big, torch.randint(10_000, 60_000, (tables, 8),
                                       generator=gen, device=dev))
    ends = raw.cumsum(1).clamp(max=n)
    sizes = torch.zeros((tables, n), dtype=torch.int64, device=dev)
    sizes[:, :head] = torch.diff(ends, dim=1, prepend=ends.new_zeros(
        (tables, 1)))
    rest = n - ends[:, -1:]
    pos = torch.arange(n, device=dev)[None, :]
    sizes += ((pos >= head) & (pos < head + rest)).long()
    offsets = torch.cat([sizes.new_zeros(1), sizes.reshape(-1).cumsum(0)])
    ids = torch.randint(0, n, (tables * n,), generator=gen, device=dev,
                        dtype=torch.int32)
    return ids, offsets.to(torch.int32)


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
    # phase 12's decode check, here where the model lives: probes=1 at the
    # default probe_min_k (256) with k_max 64 lets no head route probed, so
    # the step keeps its graph and the run is the clustered run's
    t0 = time.perf_counter()
    probed = kv.clustered_decode(params, cfg, tokens, KV_PROMPT,
                                 gcfg=kv.default_kv_config(KV_KMAX),
                                 ema=KV_EMA, refresh_every=KV_REFRESH,
                                 probes=1, device=dev)
    torch.cuda.synchronize()
    for key in ("nll", "k_stars", "overflows", "mean_k_star", "refreshes"):
        if probed[key] != runs["clustered"][key]:
            raise AssertionError(f"clustered_decode(probes=1): {key} differs "
                                 "from the clustered run")
    if not probed["cuda_graph"] or not runs["clustered"]["cuda_graph"]:
        raise AssertionError("clustered_decode(probes=1) dropped the graph")
    print(f"  (phase 12) clustered_decode(probes=1), probe_min_k 256 > k_max "
          f"{KV_KMAX}: {time.perf_counter() - t0:.2f} s, graph kept, nll, k*, "
          f"overflows and refreshes equal the clustered run's bit for bit")
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
        # a trace can drop device events (it has counted 27 of a step's
        # 28 decode kernels in some steps); the counts must hold in one
        # of DEVICE_TRACES traces
        for attempt in range(DEVICE_TRACES):
            kv.kops.l2_absorb_heads = unfused_absorb if "unfused" in run \
                else real_absorb
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    kv.clustered_decode(
                        params, cfg, tokens[:, :KV_PROMPT + KV_BUSY_STEPS],
                        KV_PROMPT, mode=mode,
                        gcfg=kv.default_kv_config(KV_KMAX), ema=KV_EMA,
                        refresh_every=KV_REFRESH, device=dev)
            finally:
                kv.kops.l2_absorb_heads = real_absorb
            busy, events, traced, named = busy_per_range(
                prof, kv.STEP_SPAN, skip=1, names=step_kernels)
            short = [(name, counts) for (name, counts), want
                     in zip(named.items(), wants)
                     if len(counts) != KV_BUSY_STEPS - 1
                     or set(counts) != {want}]
            if not short:
                break
            print(f"  ({run}: the trace counted {short}; tracing again)")
        print(f"  {run} decode step, device: {busy:.3f} ms of kernels and "
              f"copies, {events:.0f} device events (torch.profiler, steps "
              f"2-{KV_BUSY_STEPS}); busy share {busy / steps[1:].mean():.1%}"
              f" of the untraced mean step {steps[1:].mean():.3f} ms "
              f"({busy / traced:.1%} of the traced step, {traced:.3f} ms)")
        for (name, counts), want in zip(named.items(), wants):
            if len(counts) != KV_BUSY_STEPS - 1 or set(counts) != {want}:
                raise AssertionError(f"{run}: {name} ran {counts} times in "
                                     f"the traced steps, not {want} a step, "
                                     f"in {DEVICE_TRACES} traces")
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


# phase 12: probe counts of the predicts, the sub-linear regime's centers
# drawn from the fit rows, and its index (8 tables of 32-position hops:
# 768 candidates a row at probes=1)
PROBES = (0, 1)
SUBLIN_K, SUBLIN_TABLES, SUBLIN_BUCKET = 16_384, 8, 32
# phase 13: rows a streamed chunk (dense: 64 MB of float32; codes: 8 to 10
# chunks, the last ragged), the capped reservoir, and the batched predict
CHUNK_DENSE, CHUNK_CODES, SEED_CAP, BATCH = 131_072, 262_144, 100_000, 65_536


def probed_check(model, x, exact_lab, probes, what):
    """Hold ``predict(model, x, probes=)`` to the exact labels: wherever the
    exact argmin is among a row's candidates the labels agree, but at L2
    near-ties (counted); Hamming models agree exactly, distances too.
    Returns (hit share, near-ties, empty share, probed labels)."""
    from repro_torch.core import model as M
    lab, dst = M.predict(model, x, probes=probes)
    _, _, empty = M.predict_probed(model, x, probes)
    cand, mask = M.probe_candidates(model.center_index,
                                    torch.as_tensor(x, device=model.device),
                                    probes)
    mask &= model.center_valid[cand]
    hit = ((cand == exact_lab[:, None].long()) & mask).any(1)
    del cand, mask
    rows = (hit & (lab != exact_lab)).nonzero().flatten()
    ties = 0
    if model.metric == "l2":
        xd = torch.as_tensor(x, device=model.device)[rows].double()
        c = model.centers.double()
        da_ = ((xd - c[lab[rows].long()]) ** 2).sum(1)
        db_ = ((xd - c[exact_lab[rows].long()]) ** 2).sum(1)
        tol = L2_RTOL * ((xd ** 2).sum(1) + (c[model.center_valid] ** 2)
                         .sum(1).max())
        if bool(((da_ - db_).abs() > tol).any()):
            raise AssertionError(f"{what}: probed labels differ from exact "
                                 "beyond near-ties where the argmin was probed")
        ties = int(rows.numel())
    elif rows.numel():
        raise AssertionError(f"{what}: probed labels differ from exact where "
                             "the argmin was probed")
    if not bool(torch.isfinite(dst).all()):
        raise AssertionError(f"{what}: a row kept no label (non-finite dist)")
    return (float(hit.float().mean()), ties, float(empty.float().mean()),
            lab)


def index_phase(rt, dev, gen, kernels, dense, het, url):
    """Phase 12: the center index on the card. ``dense`` / ``het`` /
    ``url`` hold each kind's fitted model and fresh rows (phases 4, 7,
    8). Returns the launches on its paths."""
    from repro_torch.core import model as M
    from repro_torch.kernels import distance_argmin as da
    phase("12 center index: predict(probes=) on the card")
    total = {k.__name__: 0 for k in kernels}

    def counted(fn):
        reset_launches(*kernels)
        out = fn()
        torch.cuda.synchronize()
        for k in kernels:
            total[k.__name__] += k.launches
        return out, {k.__name__: k.launches for k in kernels}

    model, x = dense["model"], dense["x_new"]
    exact, _ = rt.predict(model, x)
    exact_ms = cuda_ms(lambda: rt.predict(model, x), 10)
    for p in PROBES:
        (hit, ties, empty, _), n_l = counted(
            lambda: probed_check(model, x, exact, p, f"dense probes={p}"))
        ms = cuda_ms(lambda: rt.predict(model, x, probes=p), 5)
        print(f"  dense k_max {model.k_max} ({int(model.k_star)} valid), "
              f"{N_FRESH:,} fresh rows, probes={p}: "
              f"{M._probe_width(model.center_index, p) * model.index_tables} "
              f"candidates a row, argmin probed {hit:.4f}, near-ties {ties}, "
              f"empty probes {empty:.4f}; L2 launches (exact fallback) "
              f"{n_l['distance_argmin_l2']}; {ms:.3f} ms against exact "
              f"{exact_ms:.3f} ms")
    # the sub-linear regime: many valid centers, a narrow window
    pick = np.random.default_rng(12).permutation(
        dense["x_fit"].shape[0])[:SUBLIN_K]
    cen = torch.as_tensor(dense["x_fit"][pick], device=dev)
    big = M.build_model(cen, torch.ones(SUBLIN_K, dtype=torch.bool,
                                         device=dev),
                         torch.tensor(SUBLIN_K, dtype=torch.int32, device=dev),
                         torch.zeros(SUBLIN_K, device=dev), metric="l2",
                         index_tables=SUBLIN_TABLES,
                         index_bucket=SUBLIN_BUCKET)
    (exact_big, _), _ = counted(lambda: rt.predict(big, x))
    (hit, ties, empty, lab), n_l = counted(
        lambda: probed_check(big, x, exact_big, 1, "sub-linear probes=1"))
    recall = float((lab == exact_big).float().mean())
    ms = cuda_ms(lambda: rt.predict(big, x, probes=1), 3)
    big_ms = cuda_ms(lambda: rt.predict(big, x), 5)
    cands = M._probe_width(big.center_index, 1) * SUBLIN_TABLES
    print(f"  sub-linear: {SUBLIN_K:,} valid centers from the fit rows, "
          f"{cands} candidates a row ({cands / SUBLIN_K:.1%} of k), probes=1:"
          f" recall {recall:.4f} against the L2 kernel's labels, argmin "
          f"probed {hit:.4f}, near-ties {ties}, empty {empty:.4f}, fallback "
          f"L2 launches {n_l['distance_argmin_l2']}; {ms:.3f} ms against "
          f"exact {big_ms:.3f} ms")
    del big, cen, exact_big, lab
    het["kernel"] = "distance_argmin_hamming"
    url["kernel"] = "distance_argmin_hamming_packed"
    for name, kind in (("hetero", het), ("sparse", url)):
        est, m_ = rt.GEEK(kind["cfg"]), kind["model"]
        codes = m_.encode(*parts_on(kind["fresh"], dev))
        (ex, _), _ = counted(lambda: rt.predict(m_, codes))
        for p in PROBES:
            (hit, _, empty, _), n_l = counted(
                lambda: probed_check(m_, codes, ex, p, f"{name} probes={p}"))
            path = kind["kernel"]
            print(f"  {name} ({m_.impl}, k* {int(m_.k_star)}), probes={p}: "
                  f"labels and distances equal the exact ones wherever the "
                  f"argmin was probed ({hit:.4f} of rows), empty probes "
                  f"{empty:.4f}; {path} launches (exact fallback) "
                  f"{n_l[path]}")
        lab_f, _ = est.predict(kind["data"](*kind["fresh"]), model=m_,
                               probes=1)
        if not torch.equal(lab_f, M.predict(m_, codes, probes=1)[0]):
            raise AssertionError(f"{name}: GEEK.predict(probes=1) differs")
    for name, m_ in (("dense", model), ("hetero", het["model"]),
                     ("sparse", url["model"])):
        with tempfile.TemporaryDirectory() as tmp:
            rt.save_model(tmp, m_)
            back = rt.restore_model(tmp)
        a, b = back.center_index, m_.center_index
        if not (torch.equal(a.sorted_keys, b.sorted_keys)
                and torch.equal(a.sorted_ids, b.sorted_ids)):
            raise AssertionError(f"{name}: the restored index differs")
    print("  save -> restore on the card: the rebuilt indexes' sorted keys "
          "and ids equal the fitted ones bit for bit (dense, hetero, sparse)")
    # a layer's heads routed through their indexes
    from repro_torch.serve import kv_cluster as kv
    H, n, hd = 8, 2048, 64
    cent = torch.randn((H, 32, hd), generator=gen, device=dev)
    keys = (cent[:, torch.randint(0, 32, (n,), generator=gen, device=dev)]
            + 0.1 * torch.randn((H, n, hd), generator=gen, device=dev))
    lay = kv.LayerKVCluster(H, hd, kv.default_kv_config(KV_KMAX), probes=1,
                            probe_min_k=1, device=dev)
    lay.start(keys.transpose(0, 1), keys.transpose(0, 1))
    new = keys[:, :256] + 0.05 * torch.randn((H, 256, hd), generator=gen,
                                             device=dev)
    if lay.probed_heads() != list(range(H)):
        raise AssertionError(f"probed heads {lay.probed_heads()}")
    got = lay.route(new)
    ties = 0
    for h in range(H):
        m_ = lay.head_model(h)
        want, _ = rt.predict(m_, new[h])
        _, t, _, lab = probed_check(m_, new[h], want, 1, f"head {h}")
        ties += t
        if not torch.equal(lab, got[h]):
            raise AssertionError(f"head {h}: route differs from predict")
    print(f"  LayerKVCluster(probes=1, probe_min_k=1), {H} heads, k* "
          f"{lay.k_stars}: each head's route is its model's probed predict, "
          f"equal to the exact labels where the argmin was probed (near-ties "
          f"{ties})")
    print(f"  launches on the phase's paths {total}")
    return total


def parts_on(parts, dev):
    """Host parts as tensors on ``dev`` (None kept)."""
    return tuple(None if p is None else torch.as_tensor(p, device=dev)
                 for p in parts)


def stream_phase(rt, dev, kernels, mesh, dense, het, url):
    """Phase 13: the streaming fit on the card, against the in-core fits
    of phases 4, 7 and 8 (``dense`` / ``het`` / ``url``: their results on
    the host, their data as host arrays). Returns the launches on its
    paths and the seed-capped streamed dense model (phase 14 swaps to
    it)."""
    phase("13 streaming fit: fit(chunk=) on the card")
    total = {k.__name__: 0 for k in kernels}

    def fit(kind, est, data, **kw):
        reset_launches(*kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_ = est.fit(data, 0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in kernels:
            total[k.__name__] += k.launches
        return m_, est.result_, wall, {k.__name__: k.launches
                                       for k in kernels}

    def same(res, m_, want, what):
        for f in ("labels", "dists"):
            if not torch.equal(getattr(res, f).cpu(), want[f]):
                raise AssertionError(f"{what}: {f} differ from the in-core fit")
        for f in ("radius", "centers", "center_valid"):
            if not torch.equal(getattr(m_, f).cpu(), want[f]):
                raise AssertionError(f"{what}: {f} differ from the in-core fit")
        if int(res.k_star) != want["k_star"]:
            raise AssertionError(f"{what}: k* differs from the in-core fit")

    x = dense["x_fit"]
    est = rt.GEEK(dense["cfg"])
    m_, res, wall, n_l = fit("dense", est, rt.DenseData(x),
                             chunk=CHUNK_DENSE)
    same(res, m_, dense, "dense chunk=")
    peak = est.stream_peak_bytes_
    print(f"  dense {x.shape[0]:,} x {x.shape[1]}, chunk {CHUNK_DENSE:,}, "
          f"seed_cap=None: {wall:.3f} s (in-core {dense['fit_s']:.3f} s); "
          f"equal to the in-core fit bit for bit; the assignment pass's "
          f"peak device memory above what it began with (peak reset after "
          f"discovery) {peak / 2**20:.1f} MiB (in-core fit's peak "
          f"{dense['peak_gb'] * 1024:.1f} MiB; dataset "
          f"{x.nbytes / 2**20:.1f} MiB); launches {n_l}")
    if peak >= x.nbytes / 2:
        raise AssertionError("the pass held more than half the dataset")
    cuts = np.cumsum([0] + [97_003, 250_000, 1, 180_113] * 4)
    cuts = np.append(cuts[cuts < x.shape[0]], x.shape[0])
    m_, res, wall, n_l = fit("dense", est, rt.DenseData(chunks=(
        x[a:b] for a, b in zip(cuts[:-1], cuts[1:]))), chunk=CHUNK_DENSE)
    same(res, m_, dense, "dense chunk iterator")
    print(f"  the same rows as {len(cuts) - 1} ragged pieces: {wall:.3f} s, "
          f"equal to the in-core fit")
    m_, res, wall, n_l = fit("dense", est, rt.DenseData(x),
                             chunk=CHUNK_DENSE, seed_cap=SEED_CAP)
    capped = m_
    want, _ = rt.predict(m_, x)
    if int(res.k_star) <= 0 or not torch.equal(res.labels, want.cpu()):
        raise AssertionError("seed_cap: k* = 0 or labels differ from predict")
    ids = res.seeds.id[res.seeds.valid]
    print(f"  seed_cap={SEED_CAP:,}: {wall:.3f} s, k*={int(res.k_star)}, "
          f"labels equal predict(model, x); seed ids are dataset rows "
          f"({int(ids.min())}..{int(ids.max())}); launches {n_l}")
    m_, res, wall, n_l = fit("dense", est, rt.DenseData(x),
                             chunk=CHUNK_DENSE, mesh=mesh)
    same(res, m_, dense, "dense chunk= mesh=")
    print(f"  chunk= with mesh= (one-rank NCCL group): {wall:.3f} s, equal to "
          f"the in-core fit")
    for name, kind in (("hetero", het), ("sparse", url)):
        est_ = rt.GEEK(kind["cfg"])
        m_, res, wall, n_l = fit(name, est_, kind["data"](*kind["parts"]),
                                 chunk=CHUNK_CODES)
        same(res, m_, kind, f"{name} chunk=")
        print(f"  {name} {res.labels.numel():,} rows, chunk {CHUNK_CODES:,}: "
              f"{wall:.3f} s (in-core {kind['fit_s']:.3f} s), equal to the "
              f"in-core fit bit for bit; the pass's peak "
              f"{est_.stream_peak_bytes_ / 2**20:.1f} MiB; launches {n_l}")
    rows = x[:300_000]
    model = dense["model"]
    for kw in (dict(), dict(probes=1)):
        full, fd = est.predict(rt.DenseData(rows), model=model, **kw)
        part, pd = est.predict(rt.DenseData(rows), model=model, batch=BATCH,
                               **kw)
        if not (torch.equal(full.cpu(), part) and torch.equal(fd.cpu(), pd)):
            raise AssertionError(f"predict(batch=) differs, {kw}")
    print(f"  GEEK.predict(batch={BATCH:,}) and (batch=, probes=1) on "
          f"{rows.shape[0]:,} rows equal their unbatched calls")
    print(f"  launches on the phase's paths {total}")
    return total, capped


# phase 14: the serving tier at the reference's defaults, on fresh raw
# rows in requests of log-uniform sizes in 1-4,096
SERVE_ROWS = {"dense": 262_144, "hetero": 65_536, "sparse": 65_536}
SERVE_MAX_BATCH, SERVE_DEADLINE_MS, SERVE_MIN_BUCKET = 4096, 5.0, 64
SERVE_RESERVOIR, SERVE_POOL_ROWS, SERVE_HTTP = 8192, 65_536, (64, 64)
SERVE_REFIT_ROWS = 32_768
# phase 15: the baselines at k = 1,024; Lloyd and sampled k-means sweep
# 10 times (launch/cluster.py's setting), sampled k-means on 256·k rows
BASE_K, BASE_ITERS, BASE_SEED = 1024, 10, 15
LLOYD_INERTIA_RTOL, LLOYD_LABELS_EQUAL = 1e-4, 0.999


def request_sizes(total, seed):
    """Request sizes drawn log-uniform in [1, SERVE_MAX_BATCH] from a
    seeded generator, until ``total`` rows (the last one cut)."""
    rng = np.random.default_rng(seed)
    sizes, left = [], total
    while left > 0:
        n = int(np.exp(rng.uniform(0.0, math.log(SERVE_MAX_BATCH + 1))))
        n = max(1, min(n, SERVE_MAX_BATCH, left))
        sizes.append(n)
        left -= n
    return sizes


def drive(server, parts, sizes, *, swap_at=None, swap_to=None,
          observe=None):
    """Submit ``sizes`` requests of consecutive host rows of ``parts`` as
    fast as they go (an open-loop burst), swapping to ``swap_to`` before
    request ``swap_at`` once the first request has been served (so both
    versions serve). Returns ([(offset, n, Assignment, latency s)], wall s
    from the first submit to the last resolution)."""
    done = {}
    futs, off = [], 0
    t0 = time.perf_counter()
    for i, n in enumerate(sizes):
        if i == swap_at:
            futs[0][3].result(timeout=600)
            server.swap(swap_to)
        rows = tuple(None if p is None else p[off:off + n] for p in parts)
        if observe is not None:
            observe(rows)
        t = time.perf_counter()
        fut = server.submit(rows)
        fut.add_done_callback(
            lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
        futs.append((off, n, t, fut))
        off += n
    out = [(o, n, f.result(timeout=600), t) for o, n, t, f in futs]
    wall = max(done.values()) - t0
    return [(o, n, a, done[i] - t) for i, (o, n, a, t) in enumerate(out)], \
        wall


def served_check(results, want, what, versions=None):
    """Every request's labels equal ``want`` (labels, dists) of its
    version (``versions[v]``, or ``want`` itself) on its rows, distances
    within 1e-6 relative. Returns the versions seen, in submit order."""
    seen = []
    for off, n, a, _ in results:
        wl, wd = want if versions is None else versions[a.version]
        wl = wl[off:off + n]
        wd = wd[off:off + n]
        if not np.array_equal(a.labels, wl):
            raise AssertionError(f"{what}: a request's labels differ from "
                                 f"predict (rows {off}..{off + n})")
        if not np.allclose(a.dists, wd, rtol=1e-6, atol=0):
            raise AssertionError(f"{what}: distances beyond 1e-6 relative")
        seen.append(a.version)
    return seen


def serve_report(name, server, results, wall, rows):
    """Print one stream's throughput, latency, padding and flushes."""
    lat = np.asarray([r[3] for r in results]) * 1e3
    st = server.stats()
    padded = st["padded_rows"] / max(st["padded_rows"] + st["rows_served"],
                                     1)
    print(f"  {name}: {rows:,} rows in {len(results)} requests: "
          f"{rows / wall:,.0f} points/s, request latency p50 "
          f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f}"
          f" ms; {st['batches']} micro-batches, padded share {padded:.4f}, "
          f"flushes {st['flushes']}, failed {st['failed']}")
    if st["failed"]:
        raise AssertionError(f"{name}: {st['failed']} requests failed")
    return dict(points_s=rows / wall, p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), padded=padded,
                batches=st["batches"], flushes=st["flushes"])


def serve_phase(rt, dev, gen, kernels, dense, het, url, capped):
    """Phase 14: the serving tier on the card, over the models phases 4,
    7 and 8 fitted (``dense`` / ``het`` / ``url``) and the seed-capped
    streamed dense model of phase 13 (``capped``, the hot-swap target).
    Returns the launches on its paths."""
    import threading
    import urllib.request

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.data.synthetic import geonames_like, sift_like, url_like
    from repro_torch.serve import (ClusterFrontend, ClusterServer,
                                   RefitAutopilot, WorkerPool)
    phase("14 serving: ClusterServer, WorkerPool, ClusterFrontend, "
          "RefitAutopilot on the card")
    total = {k.__name__: 0 for k in kernels}

    def counted(fn, name):
        reset_launches(*kernels)
        out = fn()
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in kernels}
        for k, v in got.items():
            total[k] += v
        print(f"    launches on {name}: {got}")
        return out, got

    kw = dict(max_batch=SERVE_MAX_BATCH, deadline_ms=SERVE_DEADLINE_MS,
              min_bucket=SERVE_MIN_BUCKET)
    sgen = torch.Generator(device=dev).manual_seed(14)
    x = sift_like(sgen, n=SERVE_ROWS["dense"], k=K_TRUE).x
    x_host = x.cpu().numpy()
    model = dense["model"]
    sizes = request_sizes(SERVE_ROWS["dense"], 0)
    exact = tuple(t.cpu().numpy() for t in rt.predict(model, x))
    after = tuple(t.cpu().numpy() for t in rt.predict(capped, x))
    reports = {}
    server = ClusterServer(model, **kw)
    print(f"  dense model k*={int(model.k_star)} of {model.k_max}; swap "
          f"target: phase 13's streamed fit with seed_cap={SEED_CAP:,} "
          f"(k*={int(capped.k_star)}); ladder {server.ladder}; "
          f"{len(sizes)} requests of {min(sizes)}..{max(sizes)} rows, mean "
          f"{np.mean(sizes):.1f}")
    server.warmup((x_host[:SERVE_MIN_BUCKET],))
    (res, wall), n_l = counted(lambda: drive(
        server, (x_host,), sizes, swap_at=len(sizes) // 2, swap_to=capped),
        "the exact dense stream with a swap")
    served_rows = [(off, n) for off, n, _, _ in res]
    seen = served_check(res, None, "dense exact",
                        versions={0: exact, 1: after})
    if any(b < a for a, b in zip(seen, seen[1:])) or set(seen) != {0, 1}:
        raise AssertionError(f"dense swap: versions {sorted(set(seen))} out "
                             "of order or missing")
    reports["dense exact"] = serve_report("dense exact, swap halfway", server,
                                          res, wall, SERVE_ROWS["dense"])
    if n_l["distance_argmin_l2"] < reports["dense exact"]["batches"]:
        raise AssertionError("the exact dense stream did not launch the L2 "
                             "kernel each micro-batch")
    print(f"  swap: {seen.count(0)} requests on v0, {seen.count(1)} on v1, "
          "in submit order; each request's labels are its version's "
          "predict; none failed")
    server.close()
    # the same stream, no swap, traced: the device's busy share
    server = ClusterServer(model, **kw)
    server.warmup((x_host[:SERVE_MIN_BUCKET],))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("serve_stream"):
            res, wall = drive(server, (x_host,), sizes)
    served_check(res, exact, "dense exact (traced)")
    busy, events, span, _ = busy_per_range(prof, "serve_stream")
    print(f"  the exact dense stream traced: device busy {busy:.3f} ms of "
          f"{span:.3f} ms ({busy / span:.1%}), {events:.0f} device events; "
          f"untraced wall {wall * 1e3:.3f} ms")
    reports["dense busy"] = busy / span
    server.close()
    server = ClusterServer(model, probes=1, **kw)
    server.warmup((x_host[:SERVE_MIN_BUCKET],))
    probed = tuple(t.cpu().numpy() for t in rt.predict(model, x, probes=1))
    (res, wall), n_l = counted(lambda: drive(server, (x_host,), sizes),
                               "the probed dense stream")
    served_check(res, probed, "dense probes=1")
    reports["dense probed"] = serve_report("dense probes=1", server, res,
                                           wall, SERVE_ROWS["dense"])
    server.close()
    del x
    for name, kind, make in (
            ("hetero", het, lambda g, n: geonames_like(g, n=n, k=K_HET)[:2]),
            ("sparse", url, lambda g, n: url_like(
                g, n=n, k=K_URL, nnz=NNZ_URL, universe=U_URL)[:2])):
        m_ = kind["model"]
        parts = make(sgen, SERVE_ROWS[name])
        host = tuple(p.cpu().numpy() for p in parts)
        want = tuple(t.cpu().numpy() for t in rt.GEEK(kind["cfg"]).predict(
            kind["data"](*parts), model=m_))
        server = ClusterServer(m_, **kw)
        server.warmup(tuple(p[:SERVE_MIN_BUCKET] for p in host))
        (res, wall), _ = counted(lambda: drive(
            server, host, request_sizes(SERVE_ROWS[name], 1)),
            f"the {name} stream")
        served_check(res, want, f"{name} exact")
        reports[name] = serve_report(f"{name} exact ({m_.impl})", server,
                                     res, wall, SERVE_ROWS[name])
        server.close()
        del parts
    # two workers pinned to the one card: labels, not speed
    pool = WorkerPool(model, devices=(dev, dev), **kw)
    pool.warmup((x_host[:SERVE_MIN_BUCKET],))
    (res, wall), _ = counted(lambda: drive(
        pool, (x_host[:SERVE_POOL_ROWS],), request_sizes(SERVE_POOL_ROWS, 2)),
        "the two-worker pool")
    served_check(res, tuple(a[:SERVE_POOL_ROWS] for a in exact),
                 "two-worker pool")
    st = pool.stats()
    print(f"  WorkerPool of 2 on {dev} (both workers on one card): "
          f"{SERVE_POOL_ROWS:,} rows, labels equal predict; "
          f"{SERVE_POOL_ROWS / wall:,.0f} points/s; rows per worker "
          f"{[w['rows_served'] for w in st['workers']]}, routing "
          f"{st['routing']}")
    pool.close()
    # the HTTP front end on loopback
    server = ClusterServer(model, **kw)
    reqs, rows = SERVE_HTTP
    with ClusterFrontend(server) as fe:
        t0 = time.perf_counter()
        for i in range(reqs):
            body = json.dumps({"rows": x_host[i * rows:(i + 1) * rows]
                               .tolist()}).encode()
            req = urllib.request.Request(
                fe.url + "/v1/assign", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            if out["labels"] != exact[0][i * rows:(i + 1) * rows].tolist():
                raise AssertionError(f"HTTP request {i}: labels differ")
        http_s = time.perf_counter() - t0
    print(f"  ClusterFrontend on {fe.url.split('//')[1].split(':')[0]}: "
          f"{reqs} JSON requests of {rows} rows answered with predict's "
          f"labels, {http_s / reqs * 1e3:.3f} ms a request (sequential)")
    # the autopilot: refit from the reservoir on its own thread while
    # the server keeps serving fresh traffic on the same card
    published = []

    def refit():
        published.append(ap.run_once())

    ap = RefitAutopilot(server, dense["cfg"], reservoir=SERVE_RESERVOIR,
                        min_rows=SERVE_RESERVOIR, seed=14)
    for off, n in served_rows:          # the first stream's requests
        ap.observe((x_host[off:off + n],))
    refit_sizes = request_sizes(SERVE_REFIT_ROWS, 3)
    t = threading.Thread(target=refit)

    def concurrent():
        t.start()
        out = drive(server, (x_host[:SERVE_REFIT_ROWS],), refit_sizes)
        t.join(timeout=600)
        return out

    (res, wall), n_l = counted(concurrent, "the refit + a concurrent stream")
    st = ap.stats()
    if published != [1] or st["published"] != 1:
        raise AssertionError(f"the autopilot did not publish: {published}, "
                             f"{st}")
    new = server.model
    versions = {0: exact, 1: tuple(t.cpu().numpy() for t in rt.predict(
        new, torch.as_tensor(x_host[:SERVE_REFIT_ROWS], device=dev)))}
    seen = served_check(res, None, "stream during the refit",
                        versions=versions)
    if n_l["minhash_segments"] < dense["cfg"].silk_l:
        raise AssertionError("the refit did not launch the MinHash kernel")
    print(f"  RefitAutopilot.run_once() on a {st['reservoir_rows']:,}-row "
          f"reservoir of the served dense traffic: published v1, k*="
          f"{int(new.k_star)}, gates passed (k_star, coverage, "
          f"self_assign); {len(refit_sizes)} requests served meanwhile "
          f"({seen.count(0)} on v0, {seen.count(1)} on v1), each its "
          "version's labels")
    server.close()
    print(f"  launches on the phase's paths {total}")
    return total, reports


@contextlib.contextmanager
def plain_baselines():
    """The baselines' assignments through the plain functions of
    ``core.assign`` on the card (the yardstick; never the main path)."""
    from repro_torch.core import assign, baselines
    saved = baselines.kops
    baselines.kops = types.SimpleNamespace(
        distance_argmin_l2=lambda x, c, v, block=4096: assign.assign_l2(
            x, c, v, block=block),
        distance_argmin_hamming=lambda x, c, v, block=4096:
        assign.assign_hamming(x, c, v, block=block))
    try:
        yield
    finally:
        baselines.kops = saved


@contextlib.contextmanager
def shadowed_baselines(near_ties):
    """The baselines' L2 assignments through the kernel, each held to the
    plain assignment of the same rows and centers (``l2_agreement``: labels
    equal but at near-ties); each call's (near-ties, rows) is appended
    to ``near_ties``."""
    from repro_torch.core import assign, baselines
    saved = baselines.kops

    def l2(x, c, v, block=4096):
        out = saved.distance_argmin_l2(x, c, v, block=block)
        ties, _ = l2_agreement(x, c, v, out, assign.assign_l2(x, c, v,
                                                               block=block))
        near_ties.append((ties, x.shape[0]))
        return out

    baselines.kops = types.SimpleNamespace(
        distance_argmin_l2=l2,
        distance_argmin_hamming=saved.distance_argmin_hamming)
    try:
        yield
    finally:
        baselines.kops = saved


def base_phase(rt, dev, kernels, dense, het):
    """Phase 15: the §4.1 baselines on phase 4's dense rows and phase 7's
    hetero codes, each through the kernels and through the plain path
    from the same generator state. Returns the launches on its paths."""
    from repro_torch.core import baselines as B
    phase(f"15 baselines at k = {BASE_K:,}: seed_then_assign, Lloyd, "
          "sampled k-means, k-modes, kernels vs plain")
    total = {k.__name__: 0 for k in kernels}
    rows = {}

    def run(name, fn):
        """fn(generator) through the kernels (counted, timed), then plain."""
        reset_launches(*kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(torch.Generator(device=dev).manual_seed(BASE_SEED))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_l = {k.__name__: k.launches for k in kernels}
        for k, v in n_l.items():
            total[k] += v
        with plain_baselines():
            t0 = time.perf_counter()
            plain = fn(torch.Generator(device=dev).manual_seed(BASE_SEED))
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t0
        return got, plain, wall, plain_wall, n_l

    x = torch.as_tensor(dense["x_fit"], device=dev)
    geek_inertia = float((dense["dists"].double() ** 2).mean())
    print(f"  GEEK (phase 4): fit {dense['fit_s']:.3f} s at k*="
          f"{dense['k_star']}, inertia (mean squared distance) "
          f"{geek_inertia:.6f}")
    for method in ("kmeans++", "scalable-kmeans++", "random"):
        got, plain, wall, pwall, n_l = run(
            method, lambda g: B.seed_then_assign(x, BASE_K, g, method=method))
        same = torch.equal(got.centers, plain.centers)
        if method != "scalable-kmeans++" and not same:
            raise AssertionError(f"{method}: the plain path drew other seeds")
        if not same:
            # k-means‖ draws its later candidates from the assignment's d²,
            # which the kernel and the plain product round differently
            diff = int((got.centers != plain.centers).any(1).sum())
            print(f"    {method}: {diff} of {BASE_K} seeds differ from the "
                  "plain path's (candidate rounds draw from each path's "
                  "own d²); held on the kernel path's own centers")
            with plain_baselines():
                plain = B._one_pass(x, got.centers, got.center_valid, 4096, 0)
        ties, err = l2_agreement(x, got.centers, got.center_valid,
                                 (got.labels, got.dists ** 2),
                                 (plain.labels, plain.dists ** 2))
        inertia = float((got.dists.double() ** 2).mean())
        rows[method] = dict(s=wall, plain_s=pwall, inertia=inertia)
        print(f"  seed_then_assign {method}: {wall:.3f} s (plain path "
              f"{pwall:.3f} s), inertia {inertia:.6f}; seeds equal the "
              f"plain path's: {same}; labels agree but {ties} near-ties, "
              f"max |Δd²| {err:.3g}; launches {n_l}")
    for name, fn in (
            ("lloyd", lambda g: B.lloyd(x, BASE_K, g, iters=BASE_ITERS)),
            ("sampled", lambda g: B.sampled_kmeans(x, BASE_K, g,
                                                   iters=BASE_ITERS))):
        got, plain, wall, pwall, n_l = run(name, fn)
        gi = float((got.dists.double() ** 2).mean())
        pi = float((plain.dists.double() ** 2).mean())
        eq = float((got.labels == plain.labels).float().mean())
        if abs(gi / pi - 1.0) > LLOYD_INERTIA_RTOL:
            raise AssertionError(f"{name}: inertia {gi} vs plain {pi}")
        # every sweep's kernel assignment against the plain assignment of
        # the same centers (two independent runs drift apart: a near-tie
        # flip moves two centers, and the next sweep's boundaries with
        # them)
        sweeps = []
        with shadowed_baselines(sweeps):
            fn(torch.Generator(device=dev).manual_seed(BASE_SEED))
        worst = min(1.0 - t / n for t, n in sweeps)
        if worst < LLOYD_LABELS_EQUAL:
            raise AssertionError(f"{name}: a sweep's labels equal the plain "
                                 f"assignment's on {worst:.6f} of rows")
        rows[name] = dict(s=wall, plain_s=pwall, inertia=gi)
        print(f"  {name} ({BASE_ITERS} sweeps): {wall:.3f} s (plain path "
              f"{pwall:.3f} s), inertia {gi:.6f} (plain {pi:.6f}, "
              f"{abs(gi / pi - 1.0):.2e} apart); final labels equal the "
              f"plain run's on {eq:.6f} of rows; each of its {len(sweeps)} "
              f"assignments equals the plain one on the same centers but at "
              f"{max(t for t, _ in sweeps)} near-ties (at least {worst:.6f} equal); "
              f"launches {n_l}")
    # Lloyd's first sweep: the assignment of its random initial centers
    c0 = B.random_seeds(x, BASE_K, torch.Generator(device=dev).manual_seed(
        BASE_SEED))
    ones = torch.ones(BASE_K, dtype=torch.bool, device=dev)
    first = B._one_pass(x, c0, ones, 4096, 0)
    with plain_baselines():
        first_p = B._one_pass(x, c0, ones, 4096, 0)
    ties, _ = l2_agreement(x, c0, ones, (first.labels, first.dists ** 2),
                           (first_p.labels, first_p.dists ** 2))
    print(f"  Lloyd's first sweep (its random centers): labels agree with "
          f"the plain path but {ties} near-ties")
    del x
    codes = het["model"].encode(*parts_on(het["parts"], dev))
    geek_mm = float(het["dists"].double().mean())
    got, plain, wall, pwall, n_l = run("kmodes", lambda g: B.kmodes(
        codes, BASE_K, g))
    for f in ("labels", "centers", "center_valid", "dists", "radius"):
        if not torch.equal(getattr(got, f), getattr(plain, f)):
            raise AssertionError(f"kmodes: {f} differ from the plain path")
    mm = float(got.dists.double().mean())
    rows["kmodes"] = dict(s=wall, plain_s=pwall, inertia=mm)
    print(f"  kmodes on phase 7's codes {tuple(codes.shape)} ({got.iters} "
          f"sweeps): {wall:.3f} s (plain path {pwall:.3f} s), mean mismatch "
          f"{mm:.6f}; labels, centers and distances equal the plain path's "
          f"bit for bit; launches {n_l}")
    print(f"  GEEK (phase 7): fit {het['fit_s']:.3f} s at k*={het['k_star']},"
          f" mean mismatch {geek_mm:.6f}")
    print(f"  launches on the phase's paths {total}")
    return total, rows


# phase 16: the rest of the LM substrate. Jamba-v0.1 at full width cut to
# one period of its 1:7 interleave (8 of 32 layers: attention at layer 4,
# MoE at 1, 3, 5, 7; 103 GB of bf16 weights whole, 26.6 GB cut) through
# clustered_decode with phase 11's harness; RWKV6-1.6B whole; the ten
# smoke configs on the card against the CPU
HYB_ARCH, HYB_LAYERS = "jamba_v0_1_52b", 8
RWKV_ARCH = "rwkv6_1_6b"
# the smoke configs: prompt and decode steps of a (2, 24) input
SMOKE_SHAPE, SMOKE_DECODE = (2, 24), 3
@contextlib.contextmanager
def stage_clock(dev, wraps):
    """Wrap each (owner, name, label) of ``wraps`` with a synchronized
    host clock while the block runs; yields {label: [seconds, calls]}
    (nested stages inside their parents)."""
    totals = {label: [0.0, 0] for _, _, label in wraps}
    saved = []
    for owner, name, label in wraps:
        fn = getattr(owner, name)

        def timed(*args, fn=fn, label=label, **kwargs):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            totals[label][0] += time.perf_counter() - t0
            totals[label][1] += 1
            return out
        setattr(owner, name, timed)
        saved.append((owner, name, fn))
    try:
        yield totals
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def lm_stages():
    """The LM substrate's stages for ``stage_clock``."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MoE
    from repro_torch.models import rwkv6 as R
    from repro_torch.models import ssm as SSM
    return [(L, "cache_attention", "attention"),
            (SSM, "mamba_apply", "Mamba mixer"),
            (SSM, "_causal_conv", "- causal conv"),
            (SSM, "_ssm_scan", "- selective scan"),
            (MoE, "moe_apply", "MoE"),
            (MoE, "_dispatch_local", "- dispatch (top-k, sort, scatter)"),
            (MoE, "_combine_local", "- combine"),
            (R, "rwkv_time_mix", "RWKV time mix"),
            (R, "_wkv_chunked", "- WKV, chunked"),
            (R, "_wkv_steps", "- WKV, step recurrence"),
            (R, "rwkv_channel_mix", "RWKV channel mix")]


def print_stages(totals, wall, per=1):
    for label, (secs, calls) in totals.items():
        if calls:
            print(f"    {label:36s} {secs * 1e3 / per:10.3f} ms "
                  f"{calls // per:5d} calls  {secs / wall:6.1%}")


def close_model(got, want, dtype, what, truth=None):
    """``tests/test_torch_lm.py::_close_model``: float32 within 5e-5 of
    the largest magnitude; bfloat16 within 2^-4 of it at any element and
    2^-7 on average, or, with ``truth`` (the float32 computation of a
    bf16 model with a recurrent mixer), twice the reference side's own
    error against it where that is larger. Returns (max, mean) / scale."""
    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {got.shape} {want.shape}")
    err = (got - want).abs()
    scale = float(want.abs().max())
    if dtype == "float32":
        top, mean = 5e-5 * scale, math.inf
    else:
        top, mean = 2.0**-4 * scale, 2.0**-7 * scale
        if truth is not None:
            own = (want - truth.double().cpu()).abs()
            top, mean = max(top, 2 * float(own.max())), \
                max(mean, 2 * float(own.mean()))
    if not (float(err.max()) <= top and float(err.mean()) <= mean):
        raise AssertionError(f"{what}: max {float(err.max())}, mean "
                             f"{float(err.mean())} of {scale}")
    return float(err.max()) / scale, float(err.mean()) / scale


def smoke_run(cfg, params, inputs, device):
    """Prefill ``inputs[:, :-SMOKE_DECODE]`` into caches sized to the
    whole input, then one decode step a position: the float32 logits of
    each (prefill first)."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    B, S = inputs.shape[:2]
    P = S - SMOKE_DECODE
    x = inputs.to(device)
    caches = T.stack_cache_init(cfg, B, S, device)
    h, _, _ = M.forward(params, cfg, x[:, :P], caches=caches, cache_len=0)
    out = [(h[:, -1] @ params["head"]["w"]).float()]
    for t in range(P, S):
        out.append(M.decode_step(params, cfg, caches, t, x[:, t:t + 1])[0])
    return out


def smoke_configs(rt, dev, kernels):
    """Phase 16(c): every architecture's smoke config, float32 and bf16:
    a prefill and SMOKE_DECODE decode steps on the card against the same
    on the CPU, from one draw of weights and inputs (stub frontends take
    seeded embeddings). MoE routes as ``tests/_torch_parity.py``'s
    ``MoERoutes`` holds the CPU to the reference: the CPU's recorded,
    float32 on the card equal to them token by token, bf16 fed them with
    the card's own differing choices counted as near ties."""
    import dataclasses

    from _torch_parity import MoERoutes
    from repro_torch.configs import list_archs
    from repro_torch.models import model as M
    reset_launches(*kernels)
    worst = {}
    flips = 0
    for arch in list_archs():
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(rt.get_arch(arch, smoke=True),
                                      dtype=dtype)
            cpu = M.init_params(cfg, 0, device="cpu")
            rng = np.random.default_rng(0)
            if cfg.frontend is None:
                inputs = torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, SMOKE_SHAPE))
            else:
                inputs = torch.from_numpy(rng.standard_normal(
                    SMOKE_SHAPE + (cfg.d_model,)).astype(np.float32))
            routes = MoERoutes()
            with routes.record():
                want = smoke_run(cfg, cpu, inputs, "cpu")
            inject = dtype == "bfloat16"
            truth = [None] * len(want)
            with routes.port(inject):
                got = smoke_run(cfg, tree_map(lambda t: t.to(dev), cpu),
                                inputs, dev)
                if inject and cfg.layer_pattern in ("mamba", "rwkv", "jamba"):
                    routes.next = 0
                    truth = smoke_run(dataclasses.replace(cfg,
                                                          dtype="float32"),
                                      tree_map(lambda t: t.float(), cpu),
                                      inputs, "cpu")
            flips += len(routes.flips)
            errs = [close_model(g, w, dtype, f"{arch} {dtype} step {i}", t)
                    for i, (g, w, t) in enumerate(zip(got, want, truth))]
            worst[(arch, dtype)] = tuple(max(e[j] for e in errs)
                                         for j in (0, 1))
            if not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"{arch} {dtype}: non-finite logits")
    launched = {k.__name__: k.launches for k in kernels}
    print(f"  the ten smoke configs, float32 and bfloat16, prefill of "
          f"{SMOKE_SHAPE[1] - SMOKE_DECODE} + {SMOKE_DECODE} decode steps at "
          f"batch {SMOKE_SHAPE[0]}, card vs CPU (largest |Δ| / scale, max "
          f"and mean over the steps' logits):")
    for (arch, dtype), (top, mean) in worst.items():
        print(f"    {arch:28s} {dtype:9s} {top:.3g} / {mean:.3g}")
    print(f"  bf16 routes the card would choose otherwise: {flips}, each a "
          f"near tie; launches {launched}")
    return launched


def tree_map(fn, tree):
    """``fn`` on every tensor of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def hybrid_phase(rt, dev, gen, kernels, int_rate):
    """Phase 16(a): Jamba at full width, one period, bf16, through
    ``clustered_decode`` exact and clustered (graph and eager); the
    prefill against the plain attention; the MoE drops; where the
    prefill's and a decode step's time goes; rows 1, 1a, 5, 6 and 7 at
    head_dim 128. Returns the clustered run's launches and each kernel's
    largest error against its plain version at this path's shapes."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_cluster as kv
    cfg = dataclasses.replace(rt.get_arch(HYB_ARCH), num_layers=HYB_LAYERS)
    plan = cfg.layer_plan()
    attn = [i for i, (m, _) in enumerate(plan) if m == "attn"]
    phase(f"16a hybrid LM path: {cfg.name} cut to {cfg.num_layers} of "
          f"{rt.get_arch(HYB_ARCH).num_layers} layers ({''.join(m[0] for m, _ in plan)}"
          f", MoE at {[i for i, (_, f) in enumerate(plan) if f == 'moe']}), "
          f"d_model {cfg.d_model}, prompt {KV_PROMPT}, {KV_DECODE} decoded")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = rt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    print(f"  {M.count_params(cfg):,} parameters ({M.count_active_params(cfg):,}"
          f" active), {cfg.dtype}, drawn in {time.perf_counter() - t0:.2f} s; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(weights {torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    total = KV_PROMPT + KV_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (1, total), generator=gen,
                           device=dev)
    prompt = tokens[:, :KV_PROMPT]

    # the prefill: flash_attention once a layer that attends; the pairs
    # each MoE layer drops over capacity
    dropped = []
    real_moe = MoE.moe_apply

    def counting_moe(p, x, c):
        dropped.append(int(MoE.dropped(c, x, p)))
        return real_moe(p, x, c)

    before = fa.flash_attention.launches
    MoE.moe_apply = counting_moe
    try:
        logits_k, _ = M.prefill_step(params, cfg, prompt)
    finally:
        MoE.moe_apply = real_moe
    if fa.flash_attention.launches != before + len(attn):
        raise AssertionError("the prefill did not run flash_attention once "
                             "an attention layer")
    pairs = KV_PROMPT * cfg.moe_top_k
    print(f"  MoE capacity {MoE.capacity(cfg, KV_PROMPT)} rows an expert "
          f"({cfg.moe_num_experts} experts, top {cfg.moe_top_k}): pairs "
          f"dropped over capacity a layer {dropped} of {pairs}")
    # the prefill through the plain attention: the last-token logits, and
    # (what the planted faults are read on) every position's hidden state;
    # with one attending layer of eight, a non-causal mask moves the last
    # position little (it attends to every key either way), the earlier
    # ones much
    caches = T.stack_cache_init(cfg, 1, KV_PROMPT, dev)
    hid_k, _, _ = M.forward(params, cfg, prompt, caches=caches, cache_len=0)
    plain, hidden = {}, {}
    for run in (torch.float32, torch.float64) + KV_FAULTS:
        caches = T.stack_cache_init(cfg, 1, KV_PROMPT, dev)
        over = plain_prefill_override(cfg, run) if isinstance(
            run, torch.dtype) else plain_prefill_override(cfg, fault=run)
        x, _, _ = M.forward(params, cfg, prompt, caches=caches, cache_len=0,
                            attn_override=over)
        plain[run] = (x[:, -1] @ params["head"]["w"]).float()
        hidden[run] = x.float()
    logits_p = plain[torch.float32]

    def rel_to(got, want):
        return float((got.float() - want).norm() / want.norm())

    rel = rel_to(logits_k, logits_p)
    rel64 = rel_to(logits_k, plain[torch.float64])
    rel_h = rel_to(hid_k, hidden[torch.float32])
    faults = {f: rel_to(hidden[f], hidden[torch.float32]) for f in KV_FAULTS}
    print(f"  every position's hidden state, flash_attention vs plain: "
          f"relative L2 {rel_h:.3g}; the planted faults "
          f"{', '.join(f'{f} {e:.3g}' for f, e in faults.items())}; on the "
          f"last-token logits "
          f"{', '.join(f'{f} {rel_to(plain[f], logits_p):.3g}' for f in KV_FAULTS)}")
    if not rel_h <= KV_LOGIT_RTOL:
        raise AssertionError(f"prefill hidden states differ: relative {rel_h}")
    print(f"  prefill logits, flash_attention vs plain attention: relative L2 "
          f"{rel:.3g} against float32, {rel64:.3g} against float64 "
          f"(tolerance {KV_LOGIT_RTOL}; plain float64 vs float32 "
          f"{rel_to(plain[torch.float64], logits_p):.3g}), argmax "
          f"equal: {bool(logits_k.argmax() == logits_p.argmax())}")
    if not (rel <= KV_LOGIT_RTOL and rel64 <= KV_LOGIT_RTOL):
        raise AssertionError(f"prefill logits differ: relative {rel}, {rel64}")
    if not min(faults.values()) > KV_LOGIT_RTOL:
        raise AssertionError(f"a planted fault passes the hidden-state check: "
                             f"{faults}")
    del x, logits_k, logits_p, caches, plain, hidden, hid_k

    # where the prefill's and an exact decode step's time goes
    torch.cuda.synchronize()
    with stage_clock(dev, lm_stages()) as totals:
        t0 = time.perf_counter()
        M.prefill_step(params, cfg, prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"  prefill, stages synchronized: wall {wall * 1e3:.2f} ms")
    print_stages(totals, wall)
    caches = T.stack_cache_init(cfg, 1, total, dev)
    M.forward(params, cfg, prompt, caches=caches, cache_len=0)
    steps = 8
    with stage_clock(dev, lm_stages()) as totals:
        t0 = time.perf_counter()
        for t in range(KV_PROMPT, KV_PROMPT + steps):
            M.decode_step(params, cfg, caches, t, tokens[:, t:t + 1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"  exact decode step, eager, stages synchronized: "
          f"{wall * 1e3 / steps:.3f} ms a step ({steps} steps)")
    print_stages(totals, wall, steps)
    del caches

    runs, launches = {}, {}
    for run in ("exact", "clustered", "clustered, eager"):
        reset_launches(*kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = kv.clustered_decode(params, cfg, tokens, KV_PROMPT,
                                  mode=run.split(",")[0],
                                  gcfg=kv.default_kv_config(KV_KMAX),
                                  ema=KV_EMA, refresh_every=KV_REFRESH,
                                  device=dev, cuda_graph="eager" not in run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[run] = {k.__name__: k.launches for k in kernels}
        runs[run] = out
        sec = out["seconds"]
        st = np.array(sec["steps"]) * 1e3
        print(f"  {run}: {wall:.2f} s; prefill {sec['prefill']:.4f} s, fits "
              f"{sec['fits']:.3f} s, decode step mean {st.mean():.3f} ms "
              f"(median {np.median(st):.3f}, first {st[0]:.2f}, max "
              f"{st.max():.2f}), refresh {sec['refresh']:.3f} s; ppl "
              f"{out['ppl']:.6f}; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if "k_stars" in out:
            print(f"    k* per head {out['k_stars']} (mean "
                  f"{out['mean_k_star']:.2f}), compression "
                  f"{out['compression']:.2f}, refreshes {out['refreshes']}, "
                  f"overflow {max(out['overflows'])}, graph "
                  f"{out['cuda_graph']}")
        print(f"    launches {launches[run]}")
    clus, eager = runs["clustered"], runs["clustered, eager"]
    heads = len(attn) * cfg.num_kv_heads
    if not all(math.isfinite(r["ppl"]) for r in runs.values()):
        raise AssertionError("non-finite perplexity")
    for name in ("clustered", "clustered, eager"):
        out = runs[name]
        if len(out["k_stars"]) != heads or min(out["k_stars"]) <= 0 or \
                max(out["overflows"]) != 0:
            raise AssertionError(f"{name}: a head has k* = 0 or overflow")
        if out["refreshes"] != heads * ((KV_DECODE - 1) // KV_REFRESH):
            raise AssertionError(f"{name}: refreshes {out['refreshes']}")
    if not clus["cuda_graph"] or eager["cuda_graph"]:
        raise AssertionError("the clustered run was not replayed from a graph")
    if clus["ppl"] != eager["ppl"] or clus["k_stars"] != eager["k_stars"]:
        raise AssertionError(f"graph-replayed ppl {clus['ppl']} differs from "
                             f"the eager run's {eager['ppl']}")
    per_run = len(attn) * KV_DECODE
    for run, got in launches.items():
        want_step = 0 if run == "exact" else per_run
        if got["flash_attention"] != len(attn) or \
                got["flash_centroid_decode"] != want_step or \
                got["l2_absorb_heads"] != want_step:
            raise AssertionError(f"{run}: launches {got}")
        if run != "exact" and (got["distance_argmin_l2"] <= 0
                               or got["minhash_segments"] <= 0):
            raise AssertionError("the fits did not run the L2 and MinHash "
                                 "kernels")
    sx, sc, se = (np.array(runs[r]["seconds"]["steps"]) * 1e3
                  for r in ("exact", "clustered", "clustered, eager"))
    print(f"  decode step ms (median): exact {np.median(sx):.3f}, clustered "
          f"(graph) {np.median(sc):.3f}, clustered eager {np.median(se):.3f};"
          f" prefill {clus['seconds']['prefill']:.4f} s, fits "
          f"{clus['seconds']['fits']:.3f} s, refresh "
          f"{clus['seconds']['refresh']:.3f} s; graph ppl = eager ppl = "
          f"{clus['ppl']:.6f}")

    # rows 6, 1a, 1h, 7, 1 and 5 at this path's shapes (head_dim 128)
    B, Hq, Hkv, dh = 1, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    q = torch.randn((B, KV_PROMPT, Hq, dh), generator=gen,
                    device=dev).to(torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, KV_PROMPT, Hkv, dh), generator=gen, device=dev)
            .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    S = KV_PROMPT
    fa_err = fa_check(fa.flash_attention(q, k, v, causal=True),
                      ref.attention_ref(q, k, v, causal=True),
                      f"flash_attention {(B, Hq, Hkv, S, dh)}")
    fa_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
    fa_plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), 5)
    fa_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    fa_dev = device_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20,
                       "flash_attention_bf16_kernel")
    sdpa_dev = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20, "sdpa")
    fa_bound, fa_by = bound(2.0 * dh * S * (2 * Hq + 2 * Hkv) * B,
                            [4.0 * B * Hq * dh * S * (S + 1) / 2
                             / PEAK_BF16_FLOPS])
    print(f"  flash_attention at ({B},{Hq},{Hkv},{S},{dh}) bf16 causal: max "
          f"|Δ| vs plain {fa_err:.3g}; kernel {fa_ms:.4f} ms (device "
          f"{fa_dev:.4f}), plain {fa_plain_ms:.4f} ms, SDPA {fa_lib_ms:.4f} "
          f"ms (device {sdpa_dev:.4f}), bound {fa_bound:.4f} ms ({fa_by})")
    del q, k, v
    rows = decode_kernels(dev, cfg, clus["k_stars"][:Hkv])
    for row in rows:
        print(f"  at head_dim {dh}: {row['name']} {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.7f} "
              f"({row['bound_by']}), library {row['library_ms']}")
    caches = T.stack_cache_init(cfg, 1, KV_PROMPT, dev)
    M.forward(params, cfg, prompt, caches=caches, cache_len=0)
    fit_kernels(dev, caches[attn[0]]["k"][0, :KV_PROMPT, 0].float(), int_rate)
    del caches, params
    torch.cuda.empty_cache()
    errs = {r["name"]: r["max_abs_err"] for r in rows}
    errs["flash_attention"] = fa_err
    return launches["clustered"], errs


def rwkv_phase(rt, dev, gen):
    """Phase 16(b): RWKV6-1.6B whole in bf16: a 2,048-token prefill (the
    chunked WKV) against a 2,047-token prefill (the step recurrence) and
    one decode step, in bf16 and in float32 on the same weights, then
    ``clustered_decode(mode="exact")``."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_cluster as kv
    cfg = rt.get_arch(RWKV_ARCH)
    phase(f"16b attention-free LM path: {cfg.name} whole ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.rwkv_heads} heads of "
          f"{cfg.rwkv_head_dim}), prompt {KV_PROMPT}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = rt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    print(f"  {M.count_params(cfg):,} parameters ({cfg.dtype}) drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    total = KV_PROMPT + KV_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (1, total), generator=gen,
                           device=dev)
    with stage_clock(dev, lm_stages()) as totals:
        t0 = time.perf_counter()
        chunked, _ = M.prefill_step(params, cfg, tokens[:, :KV_PROMPT])
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
    print(f"  prefill of {KV_PROMPT} (chunked WKV), stages synchronized: "
          f"wall {wall_c * 1e3:.2f} ms")
    print_stages(totals, wall_c)
    if totals["- WKV, chunked"][1] != cfg.num_layers or \
            totals["- WKV, step recurrence"][1]:
        raise AssertionError("the 2,048-token prefill did not take the "
                             "chunked branch")
    # the step branch: a prefill of KV_PROMPT - 1 positions, then one
    # decode step; both branches also in float32 on the same weights
    # (widened), the computation the bf16 model rounds
    wide = dataclasses.replace(cfg, dtype="float32")
    wide_params = tree_map(lambda t: t.float(), params)

    def stepped(c, p):
        caches = T.stack_cache_init(c, 1, KV_PROMPT, dev)
        M.forward(p, c, tokens[:, :KV_PROMPT - 1], caches=caches,
                  cache_len=0)
        return M.decode_step(p, c, caches, KV_PROMPT - 1,
                             tokens[:, KV_PROMPT - 1:KV_PROMPT])[0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_bf = stepped(cfg, params)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    chunk_32, _ = M.prefill_step(wide_params, wide, tokens[:, :KV_PROMPT])
    step_32 = stepped(wide, wide_params)
    del wide_params

    def rel(a, b):
        d = (a.double() - b.double()).abs()
        return float(d.max() / b.abs().max()), float(d.mean() / b.abs().max())

    (top32, mean32), (top, mean) = rel(step_32, chunk_32), rel(step_bf,
                                                               chunked)
    own = rel(chunked, chunk_32)[0]
    print(f"  prefill of {KV_PROMPT - 1} (step recurrence) {wall_s:.2f} s, "
          f"then a decode step: last-token logits vs the chunked prefill's, "
          f"|Δ| / scale: float32 max {top32:.3g}, mean {mean32:.3g} "
          f"(tolerance 5e-5); bf16 max {top:.3g}, mean {mean:.3g} (the "
          f"chunked bf16 run's own max |Δ| / scale against float32 "
          f"{own:.3g}; tolerance {2.0**-4:.4g} / {2.0**-7:.4g}, or twice "
          f"that own error); argmax equal: "
          f"{bool(step_bf.argmax() == chunked.argmax())}")
    close_model(step_32, chunk_32, "float32",
                "RWKV6 float32: step branch vs chunked")
    close_model(step_bf, chunked, cfg.dtype,
                "RWKV6 bf16: step branch vs chunked", truth=chunk_32)
    t0 = time.perf_counter()
    out = kv.clustered_decode(params, cfg, tokens, KV_PROMPT, mode="exact",
                              device=dev)
    torch.cuda.synchronize()
    st = np.array(out["seconds"]["steps"]) * 1e3
    print(f"  clustered_decode(mode='exact'): {time.perf_counter() - t0:.2f} "
          f"s; prefill {out['seconds']['prefill']:.4f} s, decode step mean "
          f"{st.mean():.3f} ms (median {np.median(st):.3f}); ppl "
          f"{out['ppl']:.6f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not math.isfinite(out["ppl"]) or out["steps"] != KV_DECODE:
        raise AssertionError(f"RWKV6 exact decode: {out['ppl']}")
    try:
        kv.clustered_decode(params, cfg, tokens, KV_PROMPT, device=dev)
    except ValueError as e:
        print(f"  clustered mode refused, as it must be: {e}")
    else:
        raise AssertionError("clustered_decode clustered an attention-free "
                             "model")
    del params
    torch.cuda.empty_cache()


def lm_phase(rt, dev, all_kernels, int_rate):
    """Phase 16: the hybrid path (a), RWKV6 (b), the smoke configs (c).
    Returns the launches of (a)'s clustered run and (c), by kernel, and
    the kernels' largest errors against their plain versions at (a)'s
    shapes, by name."""
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import flash_attention as fa
    kernels = all_kernels + (fa.flash_attention, fa.flash_centroid_attention,
                             fa.flash_centroid_decode,
                             da.distance_argmin_l2_heads, da.l2_absorb_heads)
    t0 = time.perf_counter()
    # a generator of its own: the phase's tokens do not hang on what the
    # earlier phases drew
    gen = torch.Generator(device=dev).manual_seed(0)
    hyb, errs = hybrid_phase(rt, dev, gen, kernels, int_rate)
    rwkv_phase(rt, dev, gen)
    phase("16c the ten smoke configs: card vs CPU")
    small = smoke_configs(rt, dev, kernels)
    total = {k: hyb[k] + small[k] for k in hyb}
    # the (B, S) centroid kernel's row counts its own launches: the decode
    # routine ticks flash_centroid_attention's count too
    total["flash_centroid_attention"] -= total["flash_centroid_decode"]
    print(f"  phase 16: {time.perf_counter() - t0:.1f} s; launches on its "
          f"paths {total}")
    return total, errs


# phase 17: training. Qwen3-0.6B whole (28 layers, bf16, remat on) at
# train_4k's sequence of 4,096, the global batch cut from 256 to 8 (2
# micro-batches of 4), AdamW with a warmup-cosine schedule, through the
# trainer (launch.train): 8 steps unbroken, and 4 steps, an async
# checkpoint, a fresh restore and steps 5-8, which must end bit for bit
# where the unbroken run ends (deterministic algorithms; CUBLAS_WORKSPACE_
# CONFIG is set at the top of this script, before CUDA starts)
TRAIN_ARGV = ["--arch", "qwen3_0_6b", "--seq", "4096", "--batch", "8",
              "--grad-accum", "2", "--steps", "8", "--lr", "1e-3",
              "--warmup", "2", "--log-every", "1"]
TRAIN_STOP = 4
# the ten smoke configs' train step, card vs CPU: a batch of (4, 32), two
# micro-batches, one AdamW step
TRAIN_SMOKE_SHAPE, TRAIN_SMOKE_LR = (4, 32), 1e-3
# the ddp-compress trainer on the one-rank NCCL group and on gloo
DDP_ARGV = ["--arch", "qwen3_0_6b", "--smoke", "--mode", "ddp-compress",
            "--steps", "2", "--batch", "4", "--seq", "32", "--lr", "1e-3",
            "--warmup", "1", "--log-every", "1"]
# the serving launcher at full width
SERVE_ARGV = ["--arch", "qwen3_0_6b", "--batch", "4", "--prompt-len", "2048",
              "--gen", "16"]


def adamw_close(got, want, lr, steps, what, wd=0.1):
    """``tests/test_torch_train.py::_adamw_close``: AdamW's parameters
    after ``steps`` steps within 1e-3 lr on average, at most 1e-3 of the
    elements more than lr / 100 apart (a step taken where a gradient is as
    small as eps), each within two steps' size a step (a step moves an
    element by at most lr · (1 + wd · |p|)). Returns (largest |Δ| / lr,
    elements more than lr / 100 apart, elements)."""
    from repro_torch.utils.tree import tree_leaves
    far = total = 0
    worst = 0.0
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        w = w.detach().float().cpu()
        err = (g.detach().float().cpu() - w).abs()
        step_size = lr * (1 + wd * float(w.abs().max()))
        if float(err.max()) > 2 * steps * step_size or \
                float(err.mean()) > 1e-3 * lr:
            raise AssertionError(f"{what} leaf {i}: max {float(err.max())}, "
                                 f"mean {float(err.mean())}")
        far += int((err > lr / 100).sum())
        total += err.numel()
        worst = max(worst, float(err.max()) / lr)
    if far > 1e-3 * total:
        raise AssertionError(f"{what}: {far} of {total} elements apart")
    return worst, far, total


def flipped(got, want, scale, tight, loose, what):
    """``tests/test_torch_train.py::_flipped``: each element within
    ``tight · scale(leaf)`` except those an int8 rounding flipped, each
    within ``loose · scale``. Returns (flipped, elements)."""
    from repro_torch.utils.tree import tree_leaves
    flips = total = 0
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        w = w.detach().float().cpu()
        err = (g.detach().float().cpu() - w).abs() / (scale(w) + 1e-30)
        if float(err.max()) > loose:
            raise AssertionError(f"{what} leaf {i}: {float(err.max())}")
        flips += int((err > tight).sum())
        total += err.numel()
    return flips, total


def train_resume(dev, card):
    """Phase 17(a): the full-width trainer, unbroken and resumed."""
    from repro_torch.launch import train as TR
    from repro_torch.utils.tree import tree_leaves
    cfg = TR.get_arch("qwen3_0_6b")
    args = TR.build_parser().parse_args(TRAIN_ARGV)
    tokens = args.batch * args.seq
    phase(f"17a training: {cfg.name} whole ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size:,}, {cfg.dtype}, "
          f"remat {cfg.remat}), seq {args.seq}, global batch {args.batch} "
          f"({args.grad_accum} micro-batches), AdamW, {args.steps} steps")

    def run(*extra, **kw):
        return TR.train(TR.build_parser().parse_args(TRAIN_ARGV + list(extra)),
                        log=lambda s: print(f"  {s}", flush=True), **kw)

    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        whole = run()
        peak = torch.cuda.max_memory_allocated()
        with tempfile.TemporaryDirectory() as ck:
            every = ["--ckpt-dir", ck, "--ckpt-every", str(TRAIN_STOP)]
            first = run(*every, stop=TRAIN_STOP)
            first_losses, blocking = first["losses"], first["save_seconds"]
            ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                             for r, _, fs in os.walk(ck) for f in fs)
            del first                   # every tensor of the first run
            torch.cuda.empty_cache()
            second = run(*every, "--resume")
    finally:
        torch.use_deterministic_algorithms(False)
    losses = whole["losses"]
    if not all(math.isfinite(v) for v in losses + second["losses"]):
        raise AssertionError(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if first_losses != losses[:TRAIN_STOP] or \
            second["losses"] != losses[TRAIN_STOP:]:
        raise AssertionError(f"resumed losses {first_losses} "
                             f"{second['losses']} against {losses}")
    for a, b in zip(tree_leaves((second["params"], second["opt_state"])),
                    tree_leaves((whole["params"], whole["opt_state"]))):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("the resumed run's parameters or AdamW "
                                 "state differ from the unbroken run's")
    n_state = sum(t.numel() for t in tree_leaves(whole["opt_state"]))
    steady = whole["step_seconds"][1:]
    ms = 1e3 * sum(steady) / len(steady)
    print(f"  losses {[round(v, 4) for v in losses]}; resumed from step "
          f"{TRAIN_STOP}: parameters ({TR.MODEL.count_params(cfg):,}) and "
          f"AdamW state ({n_state:,} floats) equal to the unbroken run's bit "
          f"for bit, losses of steps 1-4 and 5-8 equal")
    print(f"  step {ms:.1f} ms (steps 2-{args.steps}; first "
          f"{whole['step_seconds'][0] * 1e3:.1f} ms), {tokens / ms * 1e3:,.0f} "
          f"tokens/s; peak memory {peak / 2**30:.2f} GiB; checkpoint "
          f"{ckpt_bytes / 2**30:.2f} GiB, save blocking "
          f"{[round(s * 1e3, 1) for s in blocking + second['save_seconds']]} "
          f"ms; {card}")
    return whole


def train_breakdown(dev, whole):
    """Phase 17(a'): where a full-width micro-batch's time goes, from a
    device trace of its forward and backward (kernel device time by kind:
    float32 products, which are the attention's, TF32 off; the other
    products, the linear layers' and the CE head's in bf16; softmax; the
    rest) and the optimizer's update timed alone."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as TS
    from repro_torch.launch import train as TR
    args = TR.build_parser().parse_args(TRAIN_ARGV)
    cfg = TR.get_arch(args.arch)
    pipe = TR.make_pipeline(cfg, args.batch, args.seq, args.seed)
    batch = {k: v[:args.batch // args.grad_accum].to(dev)
             for k, v in pipe.global_batch(0).items()}
    params = whole["params"]
    TS.loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, grads = TS.loss_and_grads(cfg, params, batch)
        torch.cuda.synchronize()
    kinds = {"float32 products (attention)": 0.0,
             "bf16 products (linear layers, CE head)": 0.0,
             "softmax": 0.0, "other kernels": 0.0}
    top = []
    for e in prof.key_averages():
        t = e.self_device_time_total / 1e3
        if t <= 0:
            continue
        name = e.key.lower()
        top.append((t, e.key, e.count))
        if "softmax" in name:
            kinds["softmax"] += t
        elif any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet",
                                     "sm90", "sm80")):
            f32 = any(s in name for s in ("sgemm", "f32f32", "fp32", "tf32")) \
                and "bf16" not in name
            kinds["float32 products (attention)" if f32 else
                  "bf16 products (linear layers, CE head)"] += t
        else:
            kinds["other kernels"] += t
    opt = TR.adamw(TR.warmup_cosine(args.lr, args.warmup, args.steps))
    opt_ms = cuda_ms(lambda: opt.update(grads, whole["opt_state"], params,
                                        0), 2)
    total = sum(kinds.values())
    print(f"  one micro-batch ({args.batch // args.grad_accum} x {args.seq}) "
          f"forward + backward: {total:.1f} ms of device time; AdamW update "
          f"{opt_ms:.1f} ms (CUDA events)")
    for k, t in kinds.items():
        print(f"    {k:42s} {t:9.1f} ms {t / total:6.1%}")
    for t, n, c in sorted(top)[::-1][:16]:
        print(f"    {t:9.1f} ms x{c:<5d} {n[:110]}")
    return kinds, opt_ms


def train_smoke_configs(rt, dev):
    """Phase 17(b): one train step (two micro-batches, AdamW) of every
    smoke config in float32, card against CPU: the updated parameters as
    ``adamw_close``; the loss, the grad norm (relative) and each moment
    leaf (of the leaf's scale) within 1e-5 (loss, grad norm) or 1e-4
    (moments), or 4 times the step's own sensitivity, whichever is
    larger: how far each moves on the CPU when every weight is moved by
    about one float32 ulp (two draws). The card rounds each op apart from
    the CPU by about that much, and a step can be ill-conditioned:
    RWKV6's per-head group norm moves the smoke model's grad norm by
    ~1-2e-3 and its moments by ~1-2e-3 of their scale for one-ulp
    weights. MoE configs run with remat off and the card on the CPU's
    routes (near ties counted)."""
    import dataclasses

    from _torch_parity import MoERoutes
    from repro_torch.configs import list_archs
    from repro_torch.launch import steps as TS
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.utils.tree import tree_leaves
    phase("17b the ten smoke configs' train step: card vs CPU")
    flips = 0
    for arch in list_archs():
        cfg = dataclasses.replace(rt.get_arch(arch, smoke=True),
                                  dtype="float32")
        if cfg.moe_num_experts:
            cfg = dataclasses.replace(cfg, remat=False)
        cpu = rt.init_params(cfg, 0, device="cpu")
        rng = np.random.default_rng(0)
        B, S = TRAIN_SMOKE_SHAPE
        if cfg.frontend is None:
            inputs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
        else:
            inputs = torch.from_numpy(rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32))
        batch = {"inputs": inputs, "labels": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)))}
        opt = adamw(warmup_cosine(TRAIN_SMOKE_LR, 1, 4))
        step = TS.make_train_step(cfg, opt, grad_accum=2)
        routes = MoERoutes()
        with routes.record():
            pc, sc, _, mc = step(cpu, opt.init(cpu), 0, batch)
        card = tree_map(lambda t: t.to(dev), cpu)
        with routes.port(inject=True):
            pg, sg, _, mg = step(card, opt.init(card), 0,
                                 {k: v.to(dev) for k, v in batch.items()})
        flips += len(routes.flips)
        gen = torch.Generator().manual_seed(1)
        sens = {"loss": 0.0, "grad_norm": 0.0}
        moved_states = []
        for _ in range(2):
            moved = tree_map(lambda t: t * (1 + 2.0**-24 * torch.randn(
                t.shape, generator=gen)), cpu)
            _, ms, _, mp = step(moved, opt.init(moved), 0, batch)
            moved_states.append(ms)
            for k in sens:
                sens[k] = max(sens[k], abs(float(mp[k]) - float(mc[k]))
                              / abs(float(mc[k])))
        for k in ("loss", "grad_norm"):
            a, b = float(mg[k]), float(mc[k])
            tol = max(1e-5, 4 * sens[k])
            if not (math.isfinite(a) and abs(a - b) <= tol * abs(b)):
                raise AssertionError(f"{arch} {k}: card {a}, CPU {b}, "
                                     f"tolerance {tol} relative")
        worst, far, total = adamw_close(pg, pc, TRAIN_SMOKE_LR, 1,
                                        f"{arch} parameters")
        for part in ("mu", "nu"):
            for i, (g, c, *ms) in enumerate(zip(
                    *(tree_leaves(t[part])
                      for t in [sg, sc] + moved_states))):
                scale = float(c.abs().max()) + 1e-30
                own = max(float((m - c).abs().max()) for m in ms) / scale
                err = float((g.cpu() - c).abs().max()) / scale
                if err > max(1e-4, 4 * own):
                    raise AssertionError(f"{arch} {part} leaf {i}: {err} of "
                                         f"the scale, sensitivity {own}")
        print(f"    {arch:28s} loss {float(mg['loss']):.6f} (CPU "
              f"{float(mc['loss']):.6f}), grad norm {float(mg['grad_norm']):.5f}"
              f" (CPU {float(mc['grad_norm']):.5f}, one-ulp sensitivity "
              f"{sens['grad_norm']:.2g}); parameters: largest |Δ| "
              f"{worst:.3g} lr, {far} of {total:,} more than lr/100 apart")
    print(f"  MoE routes the card would choose otherwise: {flips}, each a "
          "near tie")


def train_ddp(dev):
    """Phase 17(c): ``--mode ddp-compress`` for 2 steps of the Qwen3
    smoke config through the trainer on the one-rank NCCL group; then
    each of its 2 steps (``launch.train.make_ddp_step``) on the card held
    to the same step on the CPU on a gloo group, from the same state (the
    card's, copied): the loss within 1e-5 relative, parameters as
    ``adamw_close``, moments and error-feedback residuals as ``flipped``.
    A step is held from one state, since an int8 rounding that flips
    (where the two devices' gradients straddle a half level) moves a
    parameter by ~lr, and every later gradient with it. The two devices'
    gradients at that state set the tolerances: with δ the largest
    |Δg| / max |g| of a leaf (of the reference's layout, whose stacked
    leaves are the int8 scales' groups), an element's moments move by
    about δ of their scale (held to 4 δ, at least 2e-4) and its residual
    by up to 2 · 127 δ of a level (|Δx| plus q times the scale's move; at
    least 2e-3); a flip (probability about 127 |Δg| / max |g| at each of the
    step's two roundings) moves the mean gradient by up to 2 levels, a
    moment by up to 4 levels of its scale and a residual by one, and shows
    in the element's two moments and its residual, so the flips are held
    to 4 times what the mean of |Δg| / max |g| predicts, or 1e-4 of the
    elements. Moments are compared in that layout too."""
    import torch.distributed as dist

    from repro_torch.launch import steps as TS
    from repro_torch.launch import train as TR
    from repro_torch.models.convert import to_reference_layout
    from repro_torch.utils.compat import Mesh, make_mesh
    from repro_torch.utils.tree import tree_leaves
    phase("17c ddp-compress: one-rank NCCL group vs gloo on the CPU")
    args = TR.build_parser().parse_args(DDP_ARGV + ["--device", "cuda"])
    cfg = TR.get_arch(args.arch, smoke=args.smoke)
    weights = TR.init_params(cfg, args.seed, device=dev)
    run = TR.train(args, params=weights, mesh=make_mesh(),
                   log=lambda s: print(f"  {s}"))
    opt = TR.adamw(TR.warmup_cosine(args.lr, args.warmup, args.steps))
    gloo = dist.new_group([0], backend="gloo")
    card_step = TR.make_ddp_step(cfg, opt, make_mesh())
    cpu_step = TR.make_ddp_step(cfg, opt, Mesh(group=gloo))
    pipe = TR.make_pipeline(cfg, args.batch, args.seq, args.seed)
    state = (weights, opt.init(weights), TR.ddp_residuals(weights, cfg))
    total = sum(t.numel() for t in tree_leaves(weights))
    losses = []
    for step in range(args.steps):
        batch = pipe.global_batch(step)
        g = card_step(*state, step, {k: v.to(dev) for k, v in batch.items()})
        c = cpu_step(*tree_map(lambda t: t.cpu(), list(state)), step, batch)
        grads = [to_reference_layout(TS.loss_and_grads(
            cfg, tree_map(lambda t: t.to(d), state[0]),
            {k: v.to(d) for k, v in batch.items()})[2], cfg, torch.stack,
            lambda t: t) for d in (dev, "cpu")]
        rel = [(a.cpu() - b).abs() / b.abs().max()
               for a, b in zip(*map(tree_leaves, grads))]
        delta = sum(float(r.sum()) for r in rel) / total
        delta_max = max(float(r.max()) for r in rel)
        expected = 127 * delta * total * 2 * 3
        if not abs(float(g[3]) - float(c[3])) <= 1e-5 * abs(float(c[3])):
            raise AssertionError(f"step {step + 1} loss {float(g[3])} "
                                 f"against {float(c[3])}")
        worst, far, _ = adamw_close(g[0], c[0], 1e-3, 1,
                                    f"step {step + 1} parameters")
        by_part, count = {}, 0
        for part in ("mu", "nu"):
            by_part[part], t = flipped(
                *(to_reference_layout(x[1][part], cfg, torch.stack,
                                      lambda t: t) for x in (g, c)),
                lambda w: w.abs().max(), max(2e-4, 4 * delta_max),
                4.2 / 127, f"step {step + 1} {part}")
            count += t
        by_part["resid"], t = flipped(
            g[2], c[2], lambda w: 2 * w.abs().max(),
            max(2e-3, 2 * 127 * delta_max), 1.01, f"step {step + 1} resid")
        count += t
        flips = sum(by_part.values())
        if flips > max(1e-4 * count, 4 * expected):
            raise AssertionError(f"step {step + 1}: {flips} of {count} "
                                 f"elements flipped, {expected:.0f} expected")
        print(f"  step {step + 1} from the same state: loss {float(g[3]):.6f} "
              f"(CPU {float(c[3]):.6f}); parameters largest |Δ| {worst:.3g} "
              f"lr, {far} more than lr/100 apart; gradients |Δg| largest "
              f"{delta_max:.3g}, mean {delta:.3g} of their leaves' scale; "
              f"int8 roundings flipped {by_part} of {count:,} ({expected:.0f}"
              " expected)")
        losses.append(float(g[3]))
        state = g[:3]
    dist.destroy_process_group(gloo)
    if not all(abs(a - b) <= 1e-5 * abs(b)
               for a, b in zip(run["losses"], losses)):
        raise AssertionError(f"the trainer's losses {run['losses']} against "
                             f"its steps' {losses}")


def serve_launcher(rt, dev, kernels):
    """Phase 17(d): ``launch.serve`` at full width; every prefill launch
    of flash_attention held to ``attention_ref`` (``fa_check``); the last
    decode step's logits against a full forward's over everything fed
    (relative L2, ``KV_LOGIT_RTOL``: the prefill's bf16 attention
    outputs round apart from the plain attention's); a CUDA input that
    requires grad raises in the kernel's wrapper."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    args = SV.build_parser().parse_args(SERVE_ARGV)
    cfg = rt.get_arch(args.arch)
    phase(f"17d serving launcher: {cfg.name} whole, batch {args.batch}, "
          f"prompt {args.prompt_len}, {args.gen} generated")
    errs = []
    real = kops.flash_attention

    def checked(q, k, v, *, causal=True):
        o = real(q, k, v, causal=causal)
        errs.append(fa_check(o, ref.attention_ref(q, k, v, causal=causal),
                             "serve prefill"))
        return o

    reset_launches(*kernels)
    kops.flash_attention = checked
    try:
        out = SV.serve(args, log=lambda s: print(f"  {s}"))
    finally:
        kops.flash_attention = real
    launched = {k.__name__: k.launches for k in kernels}
    if launched["flash_attention"] != cfg.num_layers or \
            len(errs) != cfg.num_layers:
        raise AssertionError(f"the prefill launched flash_attention "
                             f"{launched['flash_attention']} times")
    with torch.no_grad():
        h, _, _ = M.forward(out["params"], cfg, out["inputs"])
        full = (h[:, -1] @ out["params"]["head"]["w"]).float()
    rel = float((out["logits"] - full).norm() / full.norm())
    if not rel <= KV_LOGIT_RTOL:
        raise AssertionError(f"decode logits against a full forward: {rel}")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 16, 128, 64), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    before = fa.flash_attention.launches
    try:
        kops.flash_attention(q.requires_grad_(), k, v)
        refused = False
    except RuntimeError as e:
        refused = "forward only" in str(e)
    if not refused or fa.flash_attention.launches != before:
        raise AssertionError("flash_attention took an input that requires "
                             "grad")
    print(f"  flash_attention launches {launched['flash_attention']} (one an "
          f"attention layer), each within FA_TOL of attention_ref (largest "
          f"|Δ| {max(errs):.3g}); last decode logits vs a full forward over "
          f"the {out['inputs'].shape[1]} positions: relative L2 {rel:.3g} "
          f"(tolerance {KV_LOGIT_RTOL}), argmax equal "
          f"{float((out['logits'].argmax(-1) == full.argmax(-1)).float().mean()):.0%}"
          f"; an input that requires grad: refused")
    return launched, max(errs)


def train_phase(rt, dev, all_kernels, card):
    """Phase 17: training (a-c) and the serving launcher (d). Returns the
    launches of (d)'s path by kernel and flash_attention's largest error
    there."""
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import flash_attention as fa
    kernels = all_kernels + (fa.flash_attention, fa.flash_centroid_attention,
                             fa.flash_centroid_decode,
                             da.distance_argmin_l2_heads, da.l2_absorb_heads)
    t0 = time.perf_counter()
    reset_launches(*kernels)
    whole = train_resume(dev, card)
    train_breakdown(dev, whole)
    del whole
    torch.cuda.empty_cache()
    train_smoke_configs(rt, dev)
    train_ddp(dev)
    if any(k.launches for k in kernels):
        raise AssertionError("a training path launched a kernel: "
                             f"{ {k.__name__: k.launches for k in kernels} }")
    launched, err = serve_launcher(rt, dev, kernels)
    torch.cuda.empty_cache()
    print(f"  phase 17: {time.perf_counter() - t0:.1f} s; launches on its "
          f"paths {launched}; {card}")
    return launched, err


# phase 18: the trainer's mesh mode, 1x1 (data, model) on the one-rank NCCL
# group, two steps at phase 17's micro-batch shape (4 x 4,096)
MESH_ARGV = ["--arch", "qwen3_0_6b", "--seq", "4096", "--batch", "4",
             "--steps", "2", "--lr", "1e-3", "--warmup", "2",
             "--log-every", "1"]


def mesh_specs(rt):
    """Phase 18(c): every full-width config's parameter and AdamW state
    specs resolved to local shapes on a 1x1 (data, model) mesh: each
    shard is its whole tensor."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.steps import abstract_params
    from repro_torch.models import param_specs
    from repro_torch.models.sharding import is_spec
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import tree_leaves, tree_map
    mesh = MESH.make_test_mesh((1, 1), ("data", "model"))
    for arch in list_archs():
        cfg = rt.get_arch(arch)
        specs, ap = param_specs(cfg), abstract_params(cfg)
        local = tree_map(lambda s, t: MESH.local_shape(s, mesh, t.shape),
                         specs, ap, is_leaf=is_spec)
        state = adamw(1e-3).state_specs(specs, ap)
        n_state = sum(math.prod(MESH.local_shape(s, mesh, t.shape))
                      for k in state for s, t in zip(
                          tree_leaves(state[k], is_leaf=is_spec),
                          tree_leaves(ap)))
        shapes = tree_leaves(local, is_leaf=lambda x: isinstance(x, tuple))
        n = sum(math.prod(s) for s in shapes)
        if n != rt.count_params(cfg) or n_state != 2 * n or any(
                s != tuple(t.shape) for s, t in zip(shapes, tree_leaves(ap))):
            raise AssertionError(f"{arch}: local shapes on 1x1 are not the "
                                 "whole tensors")
        print(f"    {arch:28s} {len(shapes):4d} leaves, {n:,} parameters and "
              f"{n_state:,} AdamW floats local; largest "
              f"{max(shapes, key=math.prod)}")


def step_trace(fn, params, state, batch):
    """Two steps of a train step ``fn`` from ``(params, state)`` on
    ``batch``, the second traced by ``torch.profiler`` (the first is its
    warm-up: a trace begun cold misses launches, as ``device_ms`` says).
    Returns the traced step's span on the profiler's clock (its first
    host event to its last kernel's end, ms), the device's busy time in
    it (the kernels' intervals merged, ms), the device's idle share of
    the span, the kernels launched, and the host's top-level aten ops
    (those not inside another aten op) with their mean host time (µs).
    ``None`` when the trace holds no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.models.sharding import value
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())
                 ) as prof:
        for step in range(2):
            params, state, _, metrics = fn(params, state, step, batch)
            float(value(metrics["loss"]))
            torch.cuda.synchronize()
            prof.step()
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    if not kernels or not host:
        return None
    busy, end = 0.0, -math.inf
    for a, b in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(end, max(e.time_range.end for e in host)) - min(
        e.time_range.start for e in host)
    ops = [e for e in host if e.name.startswith("aten::") and not (
        e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::"))]
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle": 1 - busy / span, "kernels": len(kernels),
            "host_ops": len(ops),
            "host_us_per_op": sum(e.cpu_time_total for e in ops)
            / max(len(ops), 1)}


def mesh_trace(cfg, args, weights, dev):
    """Phase 18(b): one traced step of the single-card step and of the
    mesh step (``step_trace``) from the same weights and batch, each mode
    in turn."""
    from repro_torch.launch import train as TR
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw, warmup_cosine
    opt = adamw(warmup_cosine(args.lr, args.warmup, args.steps))
    batch = {k: v.to(dev) for k, v in TR.make_pipeline(
        cfg, args.batch, args.seq, args.seed).global_batch(0).items()}
    mesh = TR.build_mesh("1x1", dev)
    out = {}
    for name in ("single card", "mesh 1x1"):
        params = tree_map(lambda t: t.clone(), weights)
        state = opt.init(params)
        if name == "single card":
            fn, b = make_train_step(cfg, opt), batch
        else:
            params, state = TR.distribute_state(params, state, cfg, opt, mesh)
            fn, b = TR.make_mesh_step(cfg, opt, mesh), TR.distribute_batch(
                batch, mesh)
        torch.cuda.synchronize()
        out[name] = step_trace(fn, params, state, b)
        del params, state, fn, b
        torch.cuda.empty_cache()
        t = out[name]
        if t is None:
            print(f"  18b {name}: the trace held no kernel; device idle "
                  "share not measured")
            continue
        print(f"  18b {name}: traced step span {t['span_ms']:.1f} ms, "
              f"device busy {t['busy_ms']:.1f} ms, idle share "
              f"{t['idle']:.3f}; {t['kernels']:,} kernels, "
              f"{t['host_ops']:,} top-level aten ops on the host, "
              f"{t['host_us_per_op']:.1f} us each on average")
    return out


def mesh_phase(rt, dev, all_kernels, card):
    """Phase 18: the trainer's mesh mode at full width on a 1x1 (data,
    model) mesh of the one-rank NCCL group against the single-card
    trainer, from the same weights and batch: the losses, grad norms and
    parameters bit for bit, or else within phase 17(b)'s rule (loss and
    grad norm within 1e-5 relative or 4 times their own sensitivity, from
    two single-card runs on weights moved by about one bf16 ulp;
    parameters as ``adamw_close``); each mode's step time and peak
    memory; one traced step of each (``mesh_trace``); then
    ``mesh_specs``. No kernel launches, of rows 1-7 or of the flash and
    head wrappers (the training path has none)."""
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as TR
    from repro_torch.models.sharding import value
    from repro_torch.utils.tree import tree_leaves
    t0 = time.perf_counter()
    args = TR.build_parser().parse_args(MESH_ARGV)
    cfg = TR.get_arch(args.arch, smoke=args.smoke)
    phase(f"18 mesh-mode training: {cfg.name} whole, --mesh 1x1 (data, "
          f"model) on the one-rank NCCL group vs the single card, batch "
          f"{args.batch} x seq {args.seq}, {args.steps} AdamW steps")
    weights = TR.init_params(cfg, args.seed, device=dev)
    kernels = all_kernels + (fa.flash_attention, fa.flash_centroid_attention,
                             fa.flash_centroid_decode,
                             da.distance_argmin_l2_heads, da.l2_absorb_heads)
    reset_launches(*kernels)

    def run(extra, params):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = TR.train(TR.build_parser().parse_args(MESH_ARGV + extra),
                       params=params, log=lambda s: print(f"    {s}"))
        torch.cuda.synchronize()
        return {"losses": out["losses"], "grad_norms": out["grad_norms"],
                "params": [value(t).cpu() for t in tree_leaves(out["params"])],
                "step_seconds": out["step_seconds"],
                "peak": torch.cuda.max_memory_allocated()}

    single = run([], weights)
    mesh = run(["--mesh", "1x1"], weights)
    same = (mesh["losses"] == single["losses"]
            and mesh["grad_norms"] == single["grad_norms"]
            and all(torch.equal(a, b) for a, b in zip(mesh["params"],
                                                      single["params"])))
    if not same:
        gen = torch.Generator(device=dev).manual_seed(1)
        sens = {"losses": 0.0, "grad_norms": 0.0}
        for _ in range(2):
            moved = tree_map(lambda t: (t.float() * (1 + 2.0**-8 * torch.randn(
                t.shape, generator=gen, device=dev))).to(t.dtype), weights)
            m = run([], moved)
            for k in sens:
                sens[k] = max(sens[k], max(abs(a - b) / abs(b) for a, b in
                                           zip(m[k], single[k])))
            del m, moved
        for k in sens:
            tol = max(1e-5, 4 * sens[k])
            for a, b in zip(mesh[k], single[k]):
                if not (math.isfinite(a) and abs(a - b) <= tol * abs(b)):
                    raise AssertionError(f"mesh {k} {mesh[k]} against "
                                         f"{single[k]}, tolerance {tol}")
        adamw_close(mesh["params"], single["params"], args.lr, args.steps,
                    "mesh-mode parameters")
    if not all(math.isfinite(v) for v in mesh["losses"]):
        raise AssertionError(f"non-finite losses {mesh['losses']}")
    if any(k.launches for k in kernels):
        raise AssertionError("the mesh-mode path launched a kernel: "
                             f"{ {k.__name__: k.launches for k in kernels} }")
    tokens = args.batch * args.seq
    for name, r in (("single card", single), ("mesh 1x1", mesh)):
        ms = [round(s * 1e3, 1) for s in r["step_seconds"]]
        print(f"  {name:11s}: losses {r['losses']}, grad norms "
              f"{r['grad_norms']}; steps {ms} ms ({tokens / ms[-1] * 1e3:,.0f}"
              f" tokens/s at the last), peak {r['peak'] / 2**30:.2f} GiB")
    print(f"  mesh mode bit-identical to the single card: "
          f"{'yes' if same else 'no'}; last step "
          f"{mesh['step_seconds'][-1] / single['step_seconds'][-1]:.3f}x the "
          f"single card's; {card}")
    del single, mesh
    torch.cuda.empty_cache()
    mesh_trace(cfg, args, weights, dev)
    del weights
    torch.cuda.empty_cache()
    print("  18c spec trees of the ten full-width configs, local shapes on "
          "the 1x1 mesh:")
    mesh_specs(rt)
    print(f"  phase 18: {time.perf_counter() - t0:.1f} s")


T0 = time.perf_counter()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))     # _torch_parity
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

    def keys_for(K, gen=gen):
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
    # the layouts below draw from generators of their own, so that the
    # main paths' data stay what they were
    rng = np.random.default_rng(0)
    mgen = torch.Generator(device=dev).manual_seed(0)
    for case in mh.MINHASH_CASES:
        for K in (1, 3, 8):
            ids, offsets = (torch.from_numpy(a).to(dev)
                            for a in mh.minhash_case(case, rng))
            keys = keys_for(K, mgen)
            if not torch.equal(mh.minhash_segments(ids, offsets, keys),
                               ref.minhash_segments_ref(ids, offsets, keys)):
                raise AssertionError(f"MinHash differs on '{case}', K={K}")
    print(f"  the layouts {list(mh.MINHASH_CASES)} at K = 1, 3, 8 (short "
          f"segments up to {mh.SHORT_MAX} ids, jobs of {mh.CHUNK}): "
          "bit-exact")
    ids, offsets = code_space_layout(mgen)
    keys = keys_for(3, mgen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")     # the wrapper reads nothing
    try:
        mh.minhash_segments(ids, offsets, keys)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    minhash_at("the code-space layout (20 tables x 2,000,000 buckets)",
               (ids, offsets, keys), int_rate, card)
    del ids, offsets
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
    mh_dev_ms = device_ms(lambda: mh.minhash_segments(ids, offsets, keys),
                          10, MH_KERNELS)
    mh_bound, mh_by = minhash_bound(ids, offsets, keys, int_rate)
    print(f"  ({S} segments x {bsz} ids, K={cfg.silk_k}): bit-exact; kernel "
          f"{mh_ms:.4f} ms (device {mh_dev_ms:.4f}), plain {mh_plain_ms:.3f} "
          f"ms, bound {mh_bound:.4f} ms ({mh_by})")
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
    # what phases 12 and 13 hold the index and the streaming fit to: the
    # fitted model and estimator, the in-core result and the rows (host)
    dense = dict(model=model, cfg=cfg, x_new=x_new,
                 x_fit=x_fit.cpu().numpy(), fit_s=dense_fit_s,
                 peak_gb=peak_gb, labels=res.labels.cpu(),
                 dists=res.dists.cpu(), radius=model.radius.cpu(),
                 centers=model.centers.cpu(),
                 center_valid=model.center_valid.cpu(),
                 k_star=int(res.k_star))
    del data, x_fit, res, back, lab_fit, lab_new
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
    # a generator of their own: the later phases draw from ``gen`` what
    # they drew before these cases were added
    eq_gen = torch.Generator(device=dev).manual_seed(7)
    for case in ref.EQUALITY_CASES:
        for d in ref.EQUALITY_WIDTHS:
            codes, cen, some = ref.equality_case(case, d, 3_000, eq_gen)
            for mode, valid in (("its", some), ("no", torch.zeros_like(some))):
                ham_err = max(ham_err, ham_exact(
                    dh.distance_argmin_hamming(codes, cen, valid),
                    ref.distance_argmin_hamming_ref(codes, cen, valid),
                    f"equality, {case}, d = {d}, {mode} valid centers"))
        print(f"  equality, {case} (3000,{cen.shape[0]},d), d in "
              f"{list(ref.EQUALITY_WIDTHS)}: bit-exact, with its valid "
              "centers and with none")

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
    (het_model, het_launch, het_fit_s), het_mh = record_minhash(
        lambda: code_path(
            all_kernels, "hetero", het_est, het_fit,
            rt.HeteroData(h.x_num[N_HET:], h.x_cat[N_HET:]),
            h.true_labels[:N_HET], h.true_labels[N_HET:], K_HET,
            dh.distance_argmin_hamming))
    het = kept(het_model, het_est.result_, het_cfg, rt.HeteroData, het_fit_s,
               (h.x_num[:N_HET], h.x_cat[:N_HET]),
               (h.x_num[N_HET:], h.x_cat[N_HET:]))
    # row 5 at the inputs the fit gave it (after the path's counts)
    minhash_at("the hetero fit", het_mh, int_rate, card)
    del het_mh
    # the equality kernel at the path's own inputs: the coded fit rows and
    # the fitted modes (k* of k_max valid: the work the data needs)
    codes = het_model.encode(h.x_num[:N_HET], h.x_cat[:N_HET])
    cen, cv = het_model.centers, het_model.center_valid
    ham_err = max(ham_err, ham_exact(
        dh.distance_argmin_hamming(codes, cen, cv),
        assign.assign_hamming(codes, cen, cv), "equality at the main path"))
    eq_ms = cuda_ms(lambda: dh.distance_argmin_hamming(codes, cen, cv), 10)
    eq_dev_ms = device_ms(lambda: dh.distance_argmin_hamming(codes, cen, cv),
                          10, "equality_argmin_kernel")
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
          f"bit-exact vs plain; kernel {eq_ms:.4f} ms (device "
          f"{eq_dev_ms:.4f}), plain (blocked) {eq_plain_ms:.3f} ms, "
          f"cdist(p=0) {eq_lib_ms:.3f} ms, bound {eq_bound:.4f} ms "
          f"({eq_by}): {eq_bound / eq_ms:.1%} of it ({eq_bound / eq_dev_ms:.1%}"
          f" by device time), {card}")
    sass, per_pair = equality_sass(
        build.library_path("distance_argmin_hamming"),
        (build.CSRC / "distance_argmin_hamming.cu").read_text())
    print(f"  SASS of the equality kernel at d = 9 ({EQ_KERNEL9}): {sass}; "
          f"column compares a (row, center) pair {per_pair:.2f}")
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
    (url_model, url_launch, url_fit_s), url_mh = record_minhash(
        lambda: code_path(
            all_kernels, "sparse", url_est, url_fit,
            rt.SparseData(u.sets[N_URL:], u.mask[N_URL:]),
            u.true_labels[:N_URL], u.true_labels[N_URL:], K_URL,
            dh.distance_argmin_hamming_packed))
    url = kept(url_model, url_est.result_, url_cfg, rt.SparseData, url_fit_s,
               (u.sets[:N_URL], u.mask[:N_URL]),
               (u.sets[N_URL:], u.mask[N_URL:]))
    minhash_at("the sparse fit", url_mh, int_rate, card)
    del url_mh
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
    torch.cuda.empty_cache()
    new_paths = index_phase(rt, dev, gen, all_kernels, dense, het, url)
    del dense["x_new"]
    torch.cuda.empty_cache()
    streamed, capped = stream_phase(rt, dev, all_kernels, mesh, dense, het,
                                    url)
    for k, v in streamed.items():
        new_paths[k] += v
    print(f"  launches on phases 12 and 13's paths {new_paths}")
    torch.cuda.empty_cache()
    served, _ = serve_phase(rt, dev, gen, all_kernels, dense, het, url,
                            capped)
    del capped
    torch.cuda.empty_cache()
    based, _ = base_phase(rt, dev, all_kernels, dense, het)
    for k in new_paths:
        new_paths[k] += served[k] + based[k]
    print(f"  launches on the new paths (phases 12-15) {new_paths}, added "
          "to the kernels line")
    del dense, het, url
    torch.cuda.empty_cache()
    lm_launch, lm_errs = lm_phase(rt, dev, all_kernels, int_rate)
    for k in new_paths:
        new_paths[k] += lm_launch[k]
    train_launch, train_err = train_phase(rt, dev, all_kernels, card)
    for k in new_paths:
        new_paths[k] += train_launch[k]
    mesh_phase(rt, dev, all_kernels, card)
    lm_errs["flash_attention"] = max(lm_errs.get("flash_attention", 0.0),
                                     train_err)
    kernels = [
        {"name": "distance_argmin_l2", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:188",
         "launches": launches["l2"] + new_paths["distance_argmin_l2"],
         "max_abs_err": l2_err, "ms": l2_ms,
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
         "launches": (het_launch["distance_argmin_hamming"]
                      + new_paths["distance_argmin_hamming"]),
         "max_abs_err": ham_err, "ms": eq_ms, "plain_ms": eq_plain_ms,
         "bound_ms": eq_bound, "bound_by": eq_by, "library_ms": eq_lib_ms},
        {"name": "distance_argmin_hamming_packed", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin_hamming.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:370",
         "launches": (url_launch["distance_argmin_hamming_packed"]
                      + new_paths["distance_argmin_hamming_packed"]),
         "max_abs_err": packed_err, "ms": pk_ms, "plain_ms": pk_plain_ms,
         "bound_ms": pk_bound, "bound_by": pk_by, "library_ms": None},
        {"name": "minhash_even_buckets", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/minhash_buckets.cu",
         "replaces": "src/repro/kernels/minhash_buckets.py:58",
         "launches": (launches["minhash"] + het_launch["minhash_segments"]
                      + url_launch["minhash_segments"]
                      + new_paths["minhash_segments"]),
         "max_abs_err": mh_err, "ms": mh_ms,
         "plain_ms": mh_plain_ms, "bound_ms": mh_bound, "bound_by": mh_by,
         "library_ms": None},
    ]
    for row in flash_rows:
        row["launches"] = (kv_launch[row["name"]] + lm_launch[row["name"]]
                           + train_launch[row["name"]])
    for row in decode_rows:
        row["launches"] += lm_launch[row["name"]] + train_launch[row["name"]]
    for row in flash_rows + decode_rows:
        row["max_abs_err"] = max(row["max_abs_err"],
                                 lm_errs.get(row["name"], 0.0))
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
