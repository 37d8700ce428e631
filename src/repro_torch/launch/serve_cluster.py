"""Cluster-assignment serving CLI: a thin wrapper over ``repro_torch.serve``.

The counterpart of ``repro.launch.serve_cluster``. SILK discovery runs
once, the fitted ``GeekModel`` can be checkpointed, and a serving process
restores it and answers assignment traffic with the one-pass kernels
only. This driver fits or restores a model, stands up a
``ClusterServer`` (or a ``WorkerPool``, a ``ClusterFrontend``, a
``RefitAutopilot``), pushes fresh synthetic raw traffic through it and
reports sustained points/s with per-request p50 / p99 latency.

  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --data dense \\
      --n-fit 16384 --batch 4096 --steps 20        # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --device cpu \\
      --smoke                                      # the plain CPU path
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --data hetero \\
      --ckpt /tmp/geek_model --save   # the second run restores
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --device cpu \\
      --smoke --http :0 --workers 2 --refit-every 0.5
      # HTTP over a 2-worker pool, refit from served traffic every 0.5 s
  PYTHONPATH=src torchrun --nproc-per-node 2 -m \\
      repro_torch.launch.serve_cluster --data sparse --mesh
      # row-sharded serving over the ranks (rank 0 takes the traffic)
"""
from __future__ import annotations

import argparse
import os
import time

#: expected transform kind per data type: a restored checkpoint fitted on
#: another type is refused, not served garbage
_KIND = {"dense": "identity", "hetero": "hetero", "sparse": "sparse"}


def _draw(args, gen, n):
    """``n`` synthetic rows of ``args.data`` from ``gen``: raw parts."""
    from repro_torch.data import synthetic
    if args.data == "dense":
        return (synthetic.sift_like(gen, n=n, k=args.k).x,)
    if args.data == "hetero":
        h = synthetic.geonames_like(gen, n=n, k=args.k)
        return (h.x_num, h.x_cat)
    s = synthetic.url_like(gen, n=n, k=args.k)
    return (s.sets, s.mask)


def _fit(args, cfg, device):
    import torch

    from repro_torch.core.api import GEEK, DenseData, HeteroData, SparseData
    gen = torch.Generator(device=device).manual_seed(args.seed)
    parts = _draw(args, gen, args.n_fit)
    dataset = {"dense": DenseData, "hetero": HeteroData,
               "sparse": SparseData}[args.data](*parts)
    model = GEEK(cfg, device=device).fit(dataset, 1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return model


def _traffic(args, step: int) -> tuple:
    """A fresh batch of RAW query parts on the host (new synthetic draws
    each step); the model's transform does the coding, as at fit time."""
    import torch
    gen = torch.Generator().manual_seed(1000 + step)
    return tuple(p.numpy() for p in _draw(args, gen, args.batch))


def _drive_http(args, url: str, req_rows: int, occupancy):
    """Run the traffic loop through the socket; returns loop stats. A
    closed-loop pool of 8 in-flight requests keeps the engine fed."""
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    def post(parts):
        body = json.dumps(
            {"parts": [None if p is None else p.tolist()
                       for p in parts]}).encode()
        req = urllib.request.Request(
            url + "/v1/assign", data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.time()
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        return time.time() - t0, np.asarray(out["labels"], np.int64)

    total, latencies = 0, []
    with ThreadPoolExecutor(max_workers=8) as pool:
        for step in range(args.steps):
            batch = _traffic(args, step)
            n = next(p.shape[0] for p in batch if p is not None)
            chunks = [tuple(None if p is None else p[off:off + req_rows]
                            for p in batch)
                      for off in range(0, n, req_rows)]
            for dt, labels in pool.map(post, chunks):
                latencies.append(dt)
                total += labels.shape[0]
                occupancy += np.bincount(labels,
                                         minlength=occupancy.shape[0])
    return total, latencies, occupancy


def _mesh(device):
    """The process group ``torchrun`` describes (its environment gives
    the address, world size and rank), as a mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.utils.compat import make_mesh
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_mesh()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None,
                    choices=["dense", "hetero", "sparse"])
    ap.add_argument("--metric", default=None, choices=["l2", "hamming"],
                    help="alias: l2 -> dense, hamming -> hetero")
    ap.add_argument("--n-fit", type=int, default=16384)
    ap.add_argument("--k", type=int, default=64, help="true #clusters")
    ap.add_argument("--k-max", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4096,
                    help="rows of fresh traffic per step (also the "
                         "server's max_batch)")
    ap.add_argument("--request-rows", type=int, default=None,
                    help="rows per submitted request (default: --batch)")
    ap.add_argument("--deadline-ms", type=float, default=5.0,
                    help="micro-batch flush deadline")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="model checkpoint dir (restore if it has one)")
    ap.add_argument("--save", action="store_true",
                    help="save the fitted model to --ckpt")
    ap.add_argument("--mesh", action="store_true",
                    help="serve row-sharded over the ranks of a torchrun "
                         "launch (every rank fits the same model; rank 0 "
                         "takes the traffic)")
    ap.add_argument("--probes", type=int, default=None,
                    help="probe the model's center index with this "
                         "multi-probe radius (empty probes fall back to "
                         "the exact scan); default: exact full scan")
    ap.add_argument("--http", default=None, metavar="[HOST]:PORT",
                    help="serve over HTTP (ClusterFrontend) and drive the "
                         "traffic through the socket; ':0' picks a port")
    ap.add_argument("--workers", type=int, default=None,
                    help="serve from a WorkerPool of this many per-device "
                         "engines (cards, or the CPU with --device cpu)")
    ap.add_argument("--refit-every", type=float, default=None,
                    metavar="SECONDS",
                    help="run a RefitAutopilot: reservoir served traffic "
                         "and refit-validate-publish on this period")
    ap.add_argument("--smoke", action="store_true")
    from repro_torch.utils.platform import (add_platform_args,
                                            apply_platform_args)
    add_platform_args(ap)
    args = ap.parse_args()
    device = apply_platform_args(args)

    import numpy as np

    from repro_torch.checkpoint.manager import restore_model, save_model
    from repro_torch.core.geek import GeekConfig
    from repro_torch.serve import ClusterServer

    if args.metric is not None:
        if args.data is not None:
            raise SystemExit("[serve] pass --data OR the --metric alias, "
                             "not both")
        args.data = "dense" if args.metric == "l2" else "hetero"
    elif args.data is None:
        args.data = "dense"
    if args.smoke:
        args.n_fit, args.batch, args.steps = 2048, 512, 5

    cfg = GeekConfig(m=16, t=32, silk_l=4, delta=5, k_max=args.k_max,
                     pair_cap=1 << 15)
    mesh = _mesh(device) if args.mesh else None
    if mesh is not None:
        import torch
        device = (torch.device("cuda", torch.cuda.current_device())
                  if device.type == "cuda" else device)
    leader = mesh is None or mesh.rank == 0

    model = None
    if args.ckpt:
        try:
            model = restore_model(args.ckpt, mesh=mesh, device=device)
            kind = getattr(model.transform, "kind", None)
            if kind != _KIND[args.data]:
                raise SystemExit(
                    f"[serve] checkpoint at {args.ckpt} holds a "
                    f"{kind or 'pre-transform'} model, but --data is "
                    f"{args.data!r} — refusing to serve mismatched traffic")
            print(f"[serve] restored model from {args.ckpt} "
                  f"(k*={int(model.k_star)}, metric={model.metric}, "
                  f"transform={kind})")
        except (FileNotFoundError, ValueError) as e:
            print(f"[serve] no usable model at {args.ckpt} ({e}); fitting")
    if model is None:
        t0 = time.time()
        model = _fit(args, cfg, device)
        print(f"[serve] fitted: k*={int(model.k_star)} metric={model.metric} "
              f"impl={model.impl or '-'} time={time.time() - t0:.1f}s")
        if args.ckpt and args.save and leader:
            save_model(args.ckpt, model)
            print(f"[serve] saved model to {args.ckpt}")

    req_rows = args.request_rows or args.batch
    if args.workers is not None:
        if mesh is not None:
            raise SystemExit("[serve] --workers (per-device pool) and "
                             "--mesh (row-sharded single engine) are "
                             "different scale-out stories — pick one")
        from repro_torch.serve import WorkerPool
        from repro_torch.utils.platform import worker_devices
        server = WorkerPool(model,
                            devices=worker_devices(args.workers,
                                                   device=device),
                            probes=args.probes, max_batch=args.batch,
                            deadline_ms=args.deadline_ms)
    elif mesh is not None:
        server = ClusterServer(model, probes=args.probes, mesh=mesh,
                               max_batch=args.batch,
                               deadline_ms=args.deadline_ms)
    else:
        server = ClusterServer(model, probes=args.probes, device=device,
                               max_batch=args.batch,
                               deadline_ms=args.deadline_ms)
    if not leader:
        server.close(timeout=None)       # serve rank 0's batches to its end
        _end(mesh)
        return
    warm = _traffic(args, -1)
    server.warmup(tuple(None if p is None else p[:req_rows] for p in warm))

    autopilot = None
    if args.refit_every is not None:
        from repro_torch.serve import RefitAutopilot
        autopilot = RefitAutopilot(server, cfg, reservoir=4 * args.batch,
                                   min_rows=min(args.n_fit, 2 * args.batch),
                                   refit_every_s=args.refit_every,
                                   seed=args.seed).start()
        print(f"[serve] autopilot refitting every {args.refit_every}s "
              f"(reservoir={4 * args.batch} rows)")

    frontend = None
    if args.http is not None:
        from repro_torch.serve import ClusterFrontend
        host, _, port = args.http.rpartition(":")
        frontend = ClusterFrontend(
            server, host=host or "127.0.0.1", port=int(port or 0),
            observer=autopilot.observe if autopilot else None).start()
        print(f"[serve] http on {frontend.url} "
              "(POST /v1/assign, GET /v1/stats)")

    total, latencies = 0, []
    occupancy = np.zeros((model.k_max,), np.int64)
    t_wall = time.time()
    if frontend is not None:
        total, latencies, occupancy = _drive_http(
            args, frontend.url, req_rows, occupancy)
    else:
        for step in range(args.steps):
            batch = _traffic(args, step)
            if autopilot is not None:
                autopilot.observe(batch)   # no socket, no observer hook
            n = next(p.shape[0] for p in batch if p is not None)
            futs = []
            for off in range(0, n, req_rows):
                parts = tuple(None if p is None else p[off:off + req_rows]
                              for p in batch)
                t0 = time.time()
                futs.append((t0, server.submit(parts)))
            for t0, fut in futs:
                res = fut.result()
                latencies.append(time.time() - t0)
                total += res.labels.shape[0]
                occupancy += np.bincount(res.labels, minlength=model.k_max)
    t_wall = time.time() - t_wall
    if autopilot is not None:
        autopilot.close()
        ast = autopilot.stats()
        print(f"[serve] autopilot: {ast['refits']} refits, "
              f"{ast['published']} published, {ast['rollbacks']} "
              f"rollbacks (serving v{server.version})")
    if frontend is not None:
        frontend.close()
    server.close()

    pps = total / max(t_wall, 1e-9)
    p50, p99 = np.percentile(np.asarray(latencies) * 1e3, [50, 99])
    hot = int(occupancy.argmax())
    tag = f" x{mesh.size} ranks" if mesh is not None else ""
    tag += f" {device}"
    if args.workers is not None:
        tag += f" pool={args.workers}"
    if args.http is not None:
        tag += " http"
    if args.probes is not None:
        tag += f" probes={args.probes}"
    st = server.stats()
    if "flushes" not in st:      # WorkerPool: sum the per-worker tallies
        st["flushes"] = {
            k: sum(w["flushes"][k] for w in st["workers"])
            for k in st["workers"][0]["flushes"]}
    print(f"[serve{tag}] {args.steps} steps x {args.batch} rows "
          f"({req_rows}/request): {pps:,.0f} points/s sustained, "
          f"p50={p50:.1f}ms p99={p99:.1f}ms, "
          f"{st['batches']} micro-batches "
          f"(flushes: {st['flushes']}), "
          f"hottest cluster {hot} got {int(occupancy[hot])} points")
    _end(mesh)


def _end(mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
