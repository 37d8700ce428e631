"""GEEK clustering driver: the paper's end-to-end system beside its
baselines.

The counterpart of ``repro.launch.cluster``. Runs the transformation ->
seeding -> one-pass-assignment pipeline on synthetic analogues of the
paper's datasets through the one facade (``repro_torch.GEEK``): the
dataset picks the kind, ``--streaming`` / ``--mesh`` pick the execution
mode, and ``--seeder`` swaps the seeding stage (SILK by default; the
§4.1 seeders plug into the same pipeline). ``--distributed`` runs the
paper-§3.4 table-sync dense fit; ``--compare`` adds the baselines
(Lloyd, k-means++, random, sampled k-means; k-modes for hetero) at the
k SILK discovered.

  PYTHONPATH=src python -m repro_torch.launch.cluster --dataset sift \\
      --n 20000 --k 64 --compare                   # on the card
  PYTHONPATH=src python -m repro_torch.launch.cluster --device cpu \\
      --n 4000 --compare                           # the plain CPU path
  PYTHONPATH=src python -m repro_torch.launch.cluster --dataset url \\
      --n 100000 --streaming --chunk 8192 --seed-cap 20000
  PYTHONPATH=src python -m repro_torch.launch.cluster --dataset sift \\
      --seeder kmeanspp                            # swapped seeding stage
  PYTHONPATH=src torchrun --nproc-per-node 2 -m \\
      repro_torch.launch.cluster --dataset geonames --mesh
"""
from __future__ import annotations

import argparse
import os
import time


def mean_radius(radius, valid) -> float:
    """Mean per-cluster radius over the valid clusters."""
    import torch
    r = torch.where(valid, radius, 0.0)
    return float(r.sum() / torch.clamp(valid.sum(), min=1))


def make_dataset(args, gen):
    """One synthetic dataset as a facade Dataset spec (+ raw handle)."""
    from repro_torch.core.api import DenseData, HeteroData, SparseData
    from repro_torch.data import synthetic
    if args.dataset in ("sift", "gist"):
        make = (synthetic.sift_like if args.dataset == "sift"
                else synthetic.gist_like)
        data = make(gen, n=args.n, k=args.k)
        return DenseData(data.x), data, "geek"
    if args.dataset == "geonames":
        data = synthetic.geonames_like(gen, n=args.n, k=args.k)
        return HeteroData(data.x_num, data.x_cat), data, "geek/hetero"
    data = synthetic.url_like(gen, n=args.n, k=args.k)
    return SparseData(data.sets, data.mask), data, "geek/sparse"


def make_seeder(name: str, k: int):
    """--seeder flag -> Seeder object (None = the SILK default)."""
    from repro_torch.core.api import KMeansPPSeeder, ScalableKMeansPPSeeder
    if name == "silk":
        return None
    if name == "kmeanspp":
        return KMeansPPSeeder(k)
    return ScalableKMeansPPSeeder(k)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sift",
                    choices=["sift", "gist", "geonames", "url"])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--k", type=int, default=64, help="true #clusters")
    ap.add_argument("--k-max", type=int, default=256)
    ap.add_argument("--m", type=int, default=40)
    ap.add_argument("--t", type=int, default=64)
    ap.add_argument("--silk-l", type=int, default=6)
    ap.add_argument("--delta", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeder", default="silk",
                    choices=["silk", "kmeanspp", "scalable-kmeanspp"],
                    help="seeding stage: SILK (k* discovered) or a "
                         "k-means++ family seeder (k = --k, dense only)")
    ap.add_argument("--distributed", action="store_true",
                    help="paper-§3.4 table-sync dense fit over the ranks "
                         "of a torchrun launch")
    ap.add_argument("--mesh", action="store_true",
                    help="sharded fit over the ranks of a torchrun launch "
                         "(any data type, exact, GeekModel out)")
    ap.add_argument("--streaming", action="store_true",
                    help="out-of-core fit: device memory bounded by --chunk")
    ap.add_argument("--chunk", type=int, default=8192,
                    help="rows on device per streamed assignment step")
    ap.add_argument("--seed-cap", type=int, default=None,
                    help="max reservoir rows for streamed/sharded discovery "
                         "(default: all rows -> bit-identical to in-core)")
    ap.add_argument("--compare", action="store_true")
    from repro_torch.utils.platform import (add_platform_args,
                                            apply_platform_args)
    add_platform_args(ap)
    args = ap.parse_args()
    device = apply_platform_args(args)
    if args.streaming and args.distributed:
        raise SystemExit("--streaming and --distributed are exclusive")
    if args.mesh and args.distributed:
        raise SystemExit("--mesh and --distributed are exclusive "
                         "(--mesh is the unified sharded path)")

    import torch
    import torch.distributed as dist

    from repro_torch.core import baselines
    from repro_torch.core.api import GEEK
    from repro_torch.core.distributed import make_fit_dense
    from repro_torch.core.geek import GeekConfig, hetero_codes
    from repro_torch.utils.compat import make_mesh

    mesh = None
    if args.mesh or args.distributed:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            device = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        mesh = make_mesh()
    cfg = GeekConfig(m=args.m, t=args.t, silk_l=args.silk_l, delta=args.delta,
                     k_max=args.k_max, pair_cap=1 << 16)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dataset, data, tag = make_dataset(args, gen)
    try:
        if args.distributed:
            if dataset.kind != "dense":
                raise SystemExit("--distributed (table-sync §3.4) is "
                                 "dense-only")
            t0 = time.time()
            res = make_fit_dense(mesh, cfg, device=device)(data.x, 1)
            _sync(device)
            print(f"[geek/dist x{mesh.size}] n={args.n} "
                  f"k*={int(res.k_star)} mean_radius="
                  f"{mean_radius(res.radius, res.center_valid):.4f} "
                  f"time={time.time() - t0:.2f}s "
                  f"overflow={int(res.overflow)}")
            return
        est = GEEK(cfg, seeder=make_seeder(args.seeder, args.k),
                   device=device)
        t0 = time.time()
        # seed_cap passes through: the facade refuses it without a
        # bounded-memory mode, so a forgotten --streaming/--mesh errors
        est.fit(dataset, 1, mesh=mesh,
                chunk=args.chunk if args.streaming else None,
                seed_cap=args.seed_cap)
        res = est.result_
        _sync(device)
        dt = time.time() - t0
        if args.seeder != "silk":
            tag += f"/{args.seeder}"
        if args.streaming:
            tag += "/stream"
        if mesh is not None:
            tag += f"/sharded x{mesh.size}"
        print(f"[{tag}] n={args.n} k*={int(res.k_star)} "
              f"mean_radius={mean_radius(res.radius, res.center_valid):.4f} "
              f"time={dt:.2f}s")
        if not args.compare:
            return
        k = int(res.k_star)
        if dataset.kind == "dense":
            runs = [
                ("lloyd", lambda: baselines.lloyd(data.x, k, 2, iters=10)),
                ("kmeans++1p", lambda: baselines.seed_then_assign(
                    data.x, k, 3)),
                ("random1p", lambda: baselines.seed_then_assign(
                    data.x, k, 4, method="random")),
                ("sampled", lambda: baselines.sampled_kmeans(
                    data.x, k, 5, iters=10)),
            ]
        elif dataset.kind == "hetero":
            codes = hetero_codes(data.x_num, data.x_cat, cfg.t_cat)
            runs = [("kmodes", lambda: baselines.kmodes(codes, k, 2))]
        else:
            runs = []
        for name, fn in runs:
            t0 = time.time()
            r = fn()
            _sync(device)
            print(f"[{name:10s}] k={k} "
                  f"mean_radius={mean_radius(r.radius, r.center_valid):.4f} "
                  f"time={time.time() - t0:.2f}s")
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
