#!/usr/bin/env python3
"""Where the time of the PyTorch port's fit goes, for one data kind.

    PYTHONPATH=src python tools/profile_torch_fit.py [--kind dense|hetero|sparse]
                                                     [--n N] [--device cuda]

Runs one of ``chip_smoke.py``'s main paths (``GeekConfig()`` defaults
with its ``pair_cap``): ``dense`` on ``sift_like`` data (1M × 128),
``hetero`` on ``geonames_like`` rows (2M × (5 + 4)), ``sparse`` on
``url_like`` sets (2,396,130 × 116 items of 3,231,961), unless ``--n``.
One fit warms up (kernel build, library handles), one fit has each stage
timed by a synchronized host clock (nested stages are included in their
parents), and one fit + predict runs under ``torch.profiler`` for the
device time by kernel and the device's busy share of the wall time.
``--device cpu`` rehearses the script at a small ``--n``; its times are
the CPU's and say nothing of the card.
"""
import argparse
import collections
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import repro_torch as rt  # noqa: E402
from repro_torch.core import api, assign, lsh, silk, transform  # noqa: E402
from repro_torch.data.synthetic import (geonames_like, sift_like,  # noqa: E402
                                        url_like)
from repro_torch.kernels import ops  # noqa: E402

#: per kind: the default rows, chip_smoke.py's pair_cap, and the data
KINDS = {
    "dense": (1_000_000, 1 << 21,
              lambda gen, n: rt.DenseData(sift_like(gen, n=n, k=64).x)),
    "hetero": (2_000_000, 1 << 24,
               lambda gen, n: rt.HeteroData(*geonames_like(gen, n=n)[:2])),
    "sparse": (2_396_130, 1 << 22,
               lambda gen, n: rt.SparseData(*url_like(
                   gen, n=n, nnz=116, universe=3_231_961)[:2])),
}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed_stages(dev, kind):
    """Wrap each stage of ``kind``'s fit so that its synchronized wall
    time accumulates. Returns (totals, calls, undo)."""
    totals, calls = collections.defaultdict(float), collections.Counter()
    patched = []

    def wrap(owner, name, label):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(dev)
            totals[label] += time.perf_counter() - t0
            calls[label] += 1
            return out

        setattr(owner, name, timed)
        patched.append((owner, name, fn))

    if kind == "dense":
        wrap(api.LSHBucketer, "buckets", "bucket: QALSH x@a + stable argsort")
    else:
        wrap(api.LSHBucketer, "fit_transform", "transform: fit")
        if kind == "hetero":
            wrap(transform.HeteroTransform, "__call__",
                 "transform: quantile codes ++ categories")
        else:
            wrap(lsh, "doph_codes", "transform: DOPH codes")
        wrap(api.LSHBucketer, "buckets", "bucket: items + signatures + sort")
        wrap(lsh, "code_items", "  code_items")
        wrap(lsh, "minhash_signatures", "  minhash_signatures (L*K hashes)")
        wrap(api, "partition_by_signature", "  partition_by_signature")
    wrap(api.SILKSeeder, "seed", "silk_seeding (all rounds)")
    wrap(silk, "silk_round", "  silk_round (L seeding + 1 dedup)")
    wrap(ops, "minhash_segments", "    bucket MinHash (kernel)")
    wrap(silk, "lexsort", "    lexsort (chained stable sorts)")
    wrap(silk, "select_top_groups", "  select_top_groups")
    if kind == "dense":
        wrap(assign, "centroid_centers", "centroid_centers")
        wrap(api.KernelAssigner, "assign", "assign (L2 kernel)")
    else:
        wrap(assign, "mode_centers", "mode_centers (sorted counts)")
        wrap(api.KernelAssigner, "assign",
             "assign (equality or packed kernel)")

    def undo():
        for owner, name, fn in patched:
            setattr(owner, name, fn)

    return totals, calls, undo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=sorted(KINDS), default="dense")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    n_default, pair_cap, make = KINDS[args.kind]
    n = n_default if args.n is None else args.n
    cfg = rt.GeekConfig(pair_cap=pair_cap)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = make(gen, n)
    est = rt.GEEK(cfg, device=dev)
    est.fit(data, 0)                                    # warm-up
    sync(dev)

    totals, calls, undo = timed_stages(dev, args.kind)
    t0 = time.perf_counter()
    est.fit(data, 0)
    sync(dev)
    wall = time.perf_counter() - t0
    undo()
    print(f"device {dev} "
          f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else ''}; "
          f"{args.kind} n={n}, k*={int(est.result_.k_star)}, "
          f"overflow={int(est.result_.overflow)}")
    print(f"fit wall {wall * 1e3:.1f} ms (stages synchronized)")
    for label, secs in totals.items():
        print(f"  {label:40s} {secs * 1e3:9.1f} ms  {calls[label]:3d} calls  "
              f"{100 * secs / wall:5.1f} %")

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        est.fit(data, 0)
        est.predict(data)
        sync(dev)
        wall = time.perf_counter() - t0
    if dev.type == "cuda":
        cuda = torch.autograd.DeviceType.CUDA
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if e.device_type == cuda)
        busy, reach = 0.0, float("-inf")    # union of device intervals, us
        for start, end in spans:
            busy += max(0.0, end - max(start, reach))
            reach = max(reach, end)
        busy /= 1e6
        print(f"profiled fit + predict: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy * 1e3:.1f} ms ({100 * busy / wall:.1f} %), idle "
              f"{100 * (1 - busy / wall):.1f} %")
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages() if e.device_type == cuda),
                      reverse=True)
        for us, count, key in rows[:15]:
            print(f"  {us / 1e3:9.2f} ms {count:6d}x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
