#!/usr/bin/env python3
"""Where the time of the PyTorch port's fit goes, for one data kind.

    PYTHONPATH=src python tools/profile_torch_fit.py [--kind dense|hetero|sparse]
                                                     [--path incore|sharded|tablesync]
                                                     [--n N] [--device cuda]

Runs one of ``chip_smoke.py``'s main paths (``GeekConfig()`` defaults
with its ``pair_cap``): ``dense`` on ``sift_like`` data (1M × 128),
``hetero`` on ``geonames_like`` rows (2M × (5 + 4)), ``sparse`` on
``url_like`` sets (2,396,130 × 116 items of 3,231,961), unless ``--n``.
One fit warms up (kernel build, library handles), one fit has each stage
timed by a synchronized host clock (nested stages are included in their
parents), and one fit + predict runs under ``torch.profiler`` for the
device time by kernel and the device's busy share of the wall time.
``--path sharded`` runs the same fit with ``mesh=`` and ``--path
tablesync`` the paper's table-sync fit (``make_fit_dense``, 2 refine
sweeps; dense only), both on a one-rank process group started here (NCCL
on the card, gloo on the CPU). ``--device cpu`` rehearses the script at a
small ``--n``; its times are the CPU's and say nothing of the card.
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
from repro_torch.core import distributed as dist_mod  # noqa: E402
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


REFINE_SWEEPS = 2


def timed_stages(dev, kind, path):
    """Wrap each stage of ``kind``'s fit on ``path`` so that its
    synchronized wall time accumulates. Returns (totals, calls, undo)."""
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

    if path == "tablesync":
        wrap(lsh, "qalsh_hash", "QALSH x@a")
        wrap(dist_mod, "_quantile_boundaries", "sample-quantile boundaries")
        wrap(dist_mod, "all_to_all", "all_to_all (bucket sync)")
        wrap(dist_mod, "silk_round", "silk_round (L local + 1 dedup)")
        wrap(ops, "minhash_segments", "  bucket MinHash (kernel)")
        wrap(silk, "lexsort", "  lexsort (chained stable sorts)")
        wrap(dist_mod, "select_top_groups", "select_top_groups")
        wrap(assign, "segment_sum_rows", "centroid sums (sorted segments)")
        wrap(dist_mod, "_assign_l2_accumulate",
             "refine: assign + accumulate (kernel)")
        wrap(dist_mod, "_refine_all_reduce", "refine: all-reduce partials")
        wrap(dist_mod, "_assign_l2", "final assign (L2 kernel)")
    elif path == "sharded":
        wrap(dist_mod, "fit_transform_sharded", "transform: fit (sharded)")
        if kind == "dense":
            wrap(lsh, "qalsh_hash", "bucket: QALSH x@a")
            wrap(dist_mod, "rank_partition_slice",
                 "bucket: owned-table argsort")
        else:
            wrap(lsh, "minhash_signatures", "bucket: minhash_signatures")
            wrap(dist_mod, "signature_partition_slice",
                 "bucket: owned-table signature sort")
        wrap(dist_mod, "exchange_columns", "exchange_columns (all_to_all)")
        wrap(dist_mod, "exchange_rows", "exchange_rows (all_to_all)")
        wrap(dist_mod, "scatter_table_rows", "scatter_table_rows (all_to_all)")
        wrap(dist_mod, "silk_seeding_sharded", "silk_seeding_sharded")
        wrap(ops, "minhash_segments", "  bucket MinHash (kernel)")
        wrap(dist_mod, "bins_from_signatures", "  bins_from_signatures")
        wrap(dist_mod, "rowwise_majority", "  rowwise_majority")
        wrap(dist_mod, "compact_pairs", "  compact_pairs (local + merge)")
        wrap(dist_mod, "dedup_and_select", "  dedup + select_top_groups")
        wrap(dist_mod, "collect_seed_rows", "collect_seed_rows (all-reduce)")
        wrap(assign, "centroid_centers" if kind == "dense" else
             "mode_centers", "centers")
        wrap(api.KernelAssigner, "assign", "assign (kernel)")
    elif kind == "dense":
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
    if path == "incore":
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
    ap.add_argument("--path", choices=("incore", "sharded", "tablesync"),
                    default="incore")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.path == "tablesync" and args.kind != "dense":
        ap.error("--path tablesync is a dense fit")
    if args.path == "incore":
        return profile(args, dev, None)
    import tempfile

    import torch.distributed as dist
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as rdv:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{rdv}/rdv", rank=0,
                                world_size=1)
        try:
            dist.all_reduce(torch.zeros(1, device=dev))   # set NCCL up
            return profile(args, dev, rt.make_mesh())
        finally:
            dist.destroy_process_group()


def profile(args, dev, mesh):
    """Time the stages of one warm fit, then profile a fit + predict."""
    n_default, pair_cap, make = KINDS[args.kind]
    n = n_default if args.n is None else args.n
    gen = torch.Generator(device=dev).manual_seed(0)
    data = make(gen, n)
    if args.path == "tablesync":
        cfg = rt.GeekConfig(pair_cap=pair_cap, refine_sweeps=REFINE_SWEEPS)
        table_sync = rt.make_fit_dense(mesh, cfg, device=dev)

        def fit():
            res = table_sync(data.x, 0)
            return res.k_star, res.overflow

        def predict():
            pass
    else:
        cfg = rt.GeekConfig(pair_cap=pair_cap)
        est = rt.GEEK(cfg, device=dev)

        def fit():
            est.fit(data, 0, mesh=mesh)
            return est.result_.k_star, est.result_.overflow

        def predict():
            est.predict(data, mesh=mesh)
    fit()                                               # warm-up
    sync(dev)

    totals, calls, undo = timed_stages(dev, args.kind, args.path)
    t0 = time.perf_counter()
    k_star, overflow = fit()
    sync(dev)
    wall = time.perf_counter() - t0
    undo()
    print(f"device {dev} "
          f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else ''}; "
          f"{args.kind} {args.path} n={n}, k*={int(k_star)}, "
          f"overflow={int(overflow)}")
    print(f"fit wall {wall * 1e3:.1f} ms (stages synchronized)")
    for label, secs in totals.items():
        print(f"  {label:40s} {secs * 1e3:9.1f} ms  {calls[label]:3d} calls  "
              f"{100 * secs / wall:5.1f} %")

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fit()
        predict()
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
